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

from beso_tpu_torch.agents.policy import (PolicyConfig, PolicyState, policy_predict,
                                          policy_reset)
from beso_tpu_torch.core.densities import make_sample_density
from beso_tpu_torch.models.denoiser import GCDenoiser
from beso_tpu_torch.models.gpt import DiffusionGPT
from beso_tpu_torch.models.scaler import Scaler
from beso_tpu_torch.train.trainer import TrainState, Trainer, make_optimizer

log = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def ode_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Unit normal draws of `BesoAgent.visualize_ode`'s start, its only
    random draw."""
    return torch.randn(shape, generator=generator, device=device)


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
    def build_model(self, generator: torch.Generator) -> DiffusionGPT:
        """The config's DiffusionGPT with weights drawn from `generator` (a
        CPU generator), on the agent's device."""
        cfg = self.cfg
        return DiffusionGPT(
            state_dim=cfg.obs_dim, action_dim=cfg.action_dim, goal_dim=cfg.goal_dim,
            embed_dim=cfg.hidden_dim, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
            goal_seq_len=cfg.goal_seq_len, obs_seq_len=cfg.window_size,
            goal_conditioned=cfg.goal_conditioned, embed_pdrob=cfg.embed_pdrob,
            attn_pdrop=cfg.attn_pdrop, resid_pdrop=cfg.resid_pdrop,
            cond_mask_prob=cfg.cond_mask_prob, linear_output=cfg.linear_output,
            attention=cfg.attention, dtype=_DTYPES[cfg.compute_dtype],
            generator=generator).to(self.device)

    def init(self, generator: torch.Generator) -> TrainState:
        """Build the model with weights drawn from `generator` (a CPU
        generator), its optimizer and EMA."""
        cfg = self.cfg
        model = self.build_model(generator)
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

    def make_uncached_denoise_fn(self, params=None):
        """The denoiser of the calls that cannot use the prefix cache (a
        sampler that leaves the sigma grid, churn, several action samples, a
        goal that changes mid-episode): under 'fused_cached' the whole
        sequence on the B4 kernel (models/fused.py, `make_fused_denoise_fn`),
        under every other engine the plain forward."""
        if self.cfg.inference_engine != "fused_cached":
            return self.make_denoise_fn(params)
        from beso_tpu_torch.models.fused import make_fused_denoise_fn

        return make_fused_denoise_fn(self.eval_denoiser(params))

    def make_denoise_factory(self, policy_cfg: PolicyConfig, params=None):
        """Per-episode denoise-fn factory for the rollouts, or None (the
        plain forward).

        `inference_engine`: 'auto' (default) uses the prefix-KV cached engine
        (models/cached.py) whenever the policy config is eligible (grid-sigma
        sampler, no churn, single action sample) and the plain forward
        otherwise, as `beso_tpu/agents/beso_agent.py:198-206` does; 'cached'
        requires eligibility (raises if not); 'full' always uses the plain
        forward. 'fused_cached' runs the suffix tokens through the B1 kernels
        (models/fused.py) where the config is eligible, and the whole
        sequence through B4 (`make_uncached_denoise_fn`) where it is not; it
        never falls back to the plain forward (JAX's falls back to its full
        forward), and raises for a model the kernels cannot serve.
        """
        engine = self.cfg.inference_engine
        if engine == "full":
            return None
        from beso_tpu_torch.models.cached import make_rollout_denoise_factory

        try:
            return make_rollout_denoise_factory(
                self.eval_denoiser(params), self.scaler, policy_cfg,
                engine="fused_cached" if engine == "fused_cached" else "cached")
        except (ValueError, NotImplementedError) as err:
            if engine == "auto":
                return None  # ineligible sampler/config -> full forward
            if engine == "cached" or not isinstance(err, ValueError):
                raise
        fn = self.make_uncached_denoise_fn(params)  # fused_cached, ineligible config
        return lambda goals: fn

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

    def reset(self, batch_size: int, policy_cfg: Optional[PolicyConfig] = None) -> PolicyState:
        """Cleared rolling contexts on the agent's device (beso_agent.py:291-294)."""
        return policy_reset(batch_size, policy_cfg or self.policy_config(), self.device)

    def predict(self, pstate: PolicyState, obs: torch.Tensor, goal: torch.Tensor,
                generator: Optional[torch.Generator],
                policy_cfg: Optional[PolicyConfig] = None):
        """One batched control step with the evaluation weights
        (beso_agent.py:296-388): (action [B, act_dim] in env units, new
        state)."""
        return policy_predict(self.make_denoise_fn(), self.scaler, pstate, obs, goal,
                              generator, policy_cfg or self.policy_config())

    @torch.no_grad()
    def visualize_ode(self, state: torch.Tensor, goal: torch.Tensor,
                      generator: Optional[torch.Generator], get_mean: int = 1000,
                      new_sampling_steps: Optional[int] = None,
                      noise_scheduler: Optional[str] = None) -> torch.Tensor:
        """Debug utility (beso_agent.py:478-538): repeat one (state, goal)
        `get_mean` times and record the actions after every step of a
        step-wise DDIM trajectory. Returns [n_steps + 1, get_mean, T, act]."""
        from beso_tpu_torch.core.schedules import get_noise_schedule
        from beso_tpu_torch.sampling.samplers import sample_ddim

        cfg = self.cfg
        n = new_sampling_steps or cfg.num_sampling_steps
        sigmas = get_noise_schedule(n, cfg.sigma_min, cfg.sigma_max, cfg.rho,
                                    noise_scheduler or cfg.noise_scheduler)
        state_rpt = self.scaler.scale_input(state).repeat_interleave(get_mean, dim=0)
        goal_rpt = self.scaler.scale_input(goal).repeat_interleave(get_mean, dim=0)
        T = state.shape[-2] if state.ndim > 2 else 1
        x = ode_noise((get_mean, T, cfg.action_dim), generator, state.device) * cfg.sigma_max
        denoise = self.make_denoise_fn()

        def dn(actions, sigma):
            return denoise(state_rpt, actions, goal_rpt, sigma)

        samples = [x]
        for i in range(n):
            x = sample_ddim(dn, x, sigmas[i:i + 2])
            samples.append(x)
        return torch.stack(samples)

    # -- weight I/O ----------------------------------------------------------
    def store_model_weights(self, store_path: str):
        """Store the full train state (EMA included) as `train_state.pt`,
        superseding the reference's bare state-dict dump (beso_agent.py:466-476)."""
        from beso_tpu_torch.train.checkpoint import save_train_state

        save_train_state(self.state, store_path, "train_state")

    def load_pretrained_model(self, weights_path: str):
        if self.state is None:
            raise RuntimeError("call init() first to build a template")
        self.state = self.trainer.restore(self.state, weights_path, "train_state")
        log.info("Loaded pre-trained model parameters")

    def load_torch_checkpoint(self, weights_path: str,
                              filename: str = "model_state_dict.pth"):
        """Import a reference .pth checkpoint (beso_agent.py:458-464): its
        weights into the model, and the EMA shadow started afresh from them,
        as `beso_tpu/agents/beso_agent.py:282-291` does. The agent's model
        keeps its tanh GELU, as the JAX agent's does; the reference computed
        with erf (`DiffusionGPT(approximate_gelu=False)` reproduces it)."""
        from beso_tpu_torch.models.ema import ema_init
        from beso_tpu_torch.train.checkpoint import (load_reference_weights,
                                                     load_torch_checkpoint)

        if self.state is None:
            raise RuntimeError("call init() first to build a template")
        load_reference_weights(self.state.model, load_torch_checkpoint(
            weights_path, self.cfg.n_layers, filename))
        self.state.ema = ema_init(self.state.model.named_parameters())
