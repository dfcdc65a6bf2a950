"""High-level BESO agent: config, training, evaluation engines, weight I/O
(torch port of `beso_tpu/agents/beso_agent.py`).

Functional parity target: `BesoAgent`
(`beso/agents/diffusion_agents/beso_agent.py:28-598`), the class bundling
model + optimizer + LR schedule + EMA + sigma density + sampler selection.
A thin shell: the compute lives in `train/trainer.py`, `agents/policy.py`
(the rolling-context prediction the rollouts call) and `sampling/`.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from functools import partial
from typing import Optional

import torch

from beso_tpu_torch.agents.policy import PolicyConfig
from beso_tpu_torch.core.densities import make_sample_density
from beso_tpu_torch.models.denoiser import GCDenoiser
from beso_tpu_torch.models.gpt import DiffusionGPT
from beso_tpu_torch.models.scaler import Scaler
from beso_tpu_torch.train.trainer import TrainState, Trainer, make_optimizer

log = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class BesoAgentConfig:
    """Union of the reference's agent + model config knobs
    (configs/agents/beso_*.yaml, configs/agents/model/diffusion_gpt.yaml)."""

    # model (diffusion_gpt.yaml)
    obs_dim: int = 30
    action_dim: int = 9
    goal_dim: Optional[int] = None
    hidden_dim: int = 360
    n_layers: int = 6
    n_heads: int = 6
    goal_seq_len: int = 2          # future_seq_length
    window_size: int = 4           # obs_seq_len
    goal_conditioned: bool = True
    embed_pdrob: float = 0.0
    attn_pdrop: float = 0.3
    resid_pdrop: float = 0.0
    cond_mask_prob: float = 0.0    # goal_drop
    linear_output: bool = True
    attention: str = "auto"  # 'auto' | 'broadcast' | 'pallas' (models/gpt.py)
    # diffusion (beso_*.yaml)
    sampler_type: str = "ddim"
    num_sampling_steps: int = 3
    sigma_data: float = 0.5
    sigma_min: float = 0.005
    sigma_max: float = 1.0
    rho: float = 5.0
    noise_scheduler: str = "exponential"
    sigma_sample_density_type: str = "loglogistic"
    sigma_sample_density_mean: float = -0.6
    sigma_sample_density_std: float = 1.6
    # training
    optimizer: str = "adamw"
    lr: float = 1e-4
    betas: tuple = (0.9, 0.999)
    weight_decay: float = 0.01     # torch AdamW default, kitchen config
    lr_step_size: int = 100
    lr_gamma: float = 0.99
    max_train_steps: int = 40000
    eval_every_n_steps: int = 4000
    train_batch_size: int = 1024
    use_ema: bool = True
    decay: float = 0.999
    update_ema_every_n_steps: int = 1
    pred_last_action_only: bool = False
    # inference
    cond_lambda: float = 1.0
    compute_dtype: str = "float32"  # or 'bfloat16'
    inference_engine: str = "auto"  # 'auto' | 'cached' | 'fused_cached' | 'full'


class BesoAgent:
    def __init__(self, config: BesoAgentConfig, scaler: Scaler,
                 checkpoint_dir: Optional[str] = None, metrics_writer=None,
                 device="cuda"):
        self.cfg = config
        self.scaler = scaler
        self.device = torch.device(device)
        self.checkpoint_dir = checkpoint_dir
        self.metrics_writer = metrics_writer
        lognormal = config.sigma_sample_density_type == "lognormal"
        self.sample_density = make_sample_density(
            config.sigma_sample_density_type, config.sigma_data,
            config.sigma_min, config.sigma_max,
            loc=config.sigma_sample_density_mean if lognormal else None,
            scale=config.sigma_sample_density_std if lognormal else None)
        self.denoiser: Optional[GCDenoiser] = None
        self.trainer: Optional[Trainer] = None
        self.state: Optional[TrainState] = None

    # -- lifecycle ---------------------------------------------------------
    def init(self, generator: torch.Generator) -> TrainState:
        """Build the model with weights drawn from `generator` (a CPU
        generator), its optimizer and EMA."""
        cfg = self.cfg
        model = DiffusionGPT(
            state_dim=cfg.obs_dim, action_dim=cfg.action_dim, goal_dim=cfg.goal_dim,
            embed_dim=cfg.hidden_dim, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
            goal_seq_len=cfg.goal_seq_len, obs_seq_len=cfg.window_size,
            goal_conditioned=cfg.goal_conditioned, embed_pdrob=cfg.embed_pdrob,
            attn_pdrop=cfg.attn_pdrop, resid_pdrop=cfg.resid_pdrop,
            cond_mask_prob=cfg.cond_mask_prob, linear_output=cfg.linear_output,
            attention=cfg.attention, dtype=_DTYPES[cfg.compute_dtype],
            generator=generator).to(self.device)
        self.denoiser = GCDenoiser(model, sigma_data=cfg.sigma_data)
        self.trainer = Trainer(
            denoiser=self.denoiser,
            optimizer_factory=partial(make_optimizer, name=cfg.optimizer, lr=cfg.lr,
                                      betas=cfg.betas, weight_decay=cfg.weight_decay,
                                      lr_step_size=cfg.lr_step_size,
                                      lr_gamma=cfg.lr_gamma),
            sample_density=self.sample_density,
            scaler=self.scaler,
            max_train_steps=cfg.max_train_steps,
            eval_every_n_steps=cfg.eval_every_n_steps,
            ema_decay=cfg.decay,
            update_ema_every_n_steps=cfg.update_ema_every_n_steps,
            num_sampling_steps=cfg.num_sampling_steps,
            sigma_min=cfg.sigma_min,
            sigma_max=cfg.sigma_max,
            sampler_type=cfg.sampler_type,
            use_ema=cfg.use_ema,
            pred_last_action_only=cfg.pred_last_action_only,
            checkpoint_dir=self.checkpoint_dir,
            metrics_writer=self.metrics_writer,
        )
        self.state = self.trainer.init_state()
        n_params = sum(p.numel() for p in model.parameters())
        log.info("The model has a total amount of %d parameters", n_params)
        return self.state

    def train_agent(self, train_ds, test_ds, generator: torch.Generator,
                    batch_size: Optional[int] = None, train_method: str = "steps",
                    max_epochs: int = 100, patience: int = 80) -> TrainState:
        """Step- or epoch-based training (beso_agent.py:119-213)."""
        bs = batch_size or self.cfg.train_batch_size

        def test_batches():
            return test_ds.epoch_batches(min(bs, max(len(test_ds), 1)))

        if train_method == "epochs":
            self.state = self.trainer.train_on_epochs(
                self.state, train_ds, test_batches, generator, max_epochs,
                batch_size=bs, patience=patience)
        elif train_method == "steps":
            self.state = self.trainer.train(self.state, train_ds, test_batches,
                                            generator, batch_size=bs)
        else:
            raise ValueError("Either epochs or n_steps must be specified!")
        return self.state

    # -- inference ---------------------------------------------------------
    def eval_params(self):
        """The EMA shadow (name -> tensor), or None for the live weights."""
        if self.state is None:
            raise RuntimeError("call init() first")
        return self.state.ema.params if self.cfg.use_ema else None

    def eval_denoiser(self, params=None) -> GCDenoiser:
        """A denoiser whose inner model holds the evaluation weights (a copy
        of the model with `params` loaded), for the engines that read the
        model's weights directly."""
        params = self.eval_params() if params is None else params
        if params is None:
            return self.denoiser
        model = copy.deepcopy(self.denoiser.inner_model)
        model.load_state_dict(params, strict=False)
        return GCDenoiser(model, sigma_data=self.denoiser.sigma_data)

    def make_denoise_fn(self, params=None):
        params = self.eval_params() if params is None else params
        return partial(self.denoiser, params=params)

    def make_denoise_factory(self, policy_cfg: PolicyConfig, params=None):
        """Per-episode denoise-fn factory for the rollouts, or None.

        `inference_engine`: 'auto' (default) uses the prefix-KV cached engine
        (models/cached.py) whenever the policy config is eligible (grid-sigma
        sampler, no churn, single action sample); 'cached' requires
        eligibility (raises if not); 'fused_cached' runs the suffix tokens
        through the fused layer kernels (models/fused.py); 'full' always uses
        the plain forward. Every engine but 'cached' falls back to the full
        forward (None) when the config is ineligible, as
        `beso_tpu/agents/beso_agent.py:198-206` does.
        """
        engine = self.cfg.inference_engine
        if engine == "full":
            return None
        from beso_tpu_torch.models.cached import make_rollout_denoise_factory

        try:
            return make_rollout_denoise_factory(
                self.eval_denoiser(params), self.scaler, policy_cfg,
                engine="fused_cached" if engine == "fused_cached" else "cached")
        except (ValueError, NotImplementedError):
            if engine == "cached":
                raise
            return None  # ineligible sampler/config -> full forward

    def policy_config(self, **overrides) -> PolicyConfig:
        base = dict(
            window_size=self.cfg.window_size,
            obs_dim=self.cfg.obs_dim,
            action_dim=self.cfg.action_dim,
            sampler_type=self.cfg.sampler_type,
            num_sampling_steps=self.cfg.num_sampling_steps,
            sigma_min=self.cfg.sigma_min,
            sigma_max=self.cfg.sigma_max,
            sigma_data=self.cfg.sigma_data,
            rho=self.cfg.rho,
            noise_scheduler=self.cfg.noise_scheduler,
            cond_lambda=self.cfg.cond_lambda,
        )
        base.update({k: v for k, v in overrides.items() if v is not None})
        return PolicyConfig(**base)

    # -- weight I/O ----------------------------------------------------------
    def store_model_weights(self, store_path: str):
        """Store the full train state (EMA included) as `train_state.pt`,
        superseding the reference's bare state-dict dump (beso_agent.py:466-476)."""
        from beso_tpu_torch.train.checkpoint import save_train_state

        save_train_state(self.state, store_path, "train_state")

    def load_pretrained_model(self, weights_path: str):
        from beso_tpu_torch.train.checkpoint import restore_train_state

        if self.state is None:
            raise RuntimeError("call init() first to build a template")
        self.state = restore_train_state(self.state, weights_path, "train_state")
        log.info("Loaded pre-trained model parameters")
