"""The rollout driver: whole kitchen evaluation episodes, back to back, in a
closed loop, through `beso_tpu_torch.rollout.rollout.rollout_kitchen` and
the engine `BesoAgent.make_denoise_factory` picks.

A traffic file of kind "rollout" sets the envs, the episode length, the
sampler (and its churn) and the engine; the configuration sets the model.
The driver wraps the per-episode denoiser the factory builds and the
rollout's physics step, and keeps, at steps drawn from the seed, their
inputs and outputs: every denoiser call of the step and of the next one,
and the env state before and after. After the window the reference judges
them (`judge`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import kitchen as ref_kitchen
from benchmark.reference import model as ref_model
from benchmark.reference import sampling as ref_sampling
from benchmark.reference.precision import set_exact_matmul

_STATE_FIELDS = ("qpos", "ee_pos", "tasks_to_complete", "completed", "completion_order",
                 "kettle_grasped", "done", "steps")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Capture:
    """Counts episodes, env steps and denoiser calls, keeps the calls and
    physics steps of the drawn steps, and tells the tracer where each env
    step starts."""

    def __init__(self, calls_per_step: int, plan):
        self.calls_per_step, self.plan = calls_per_step, plan
        self.episode, self.call, self.env_step, self.global_step = -1, 0, 0, 0
        self.active, self.tracer = False, None
        self.targets: set = set()
        self.calls: dict = {}   # (episode, step) -> [(states, actions, goals, sigma, out)]
        self.steps: dict = {}   # (episode, step) -> (state before, action, state after)
        self.judged: list = []  # (episode, step): steps judged with their successor

    def wrap_factory(self, factory):
        def episode_factory(goals):
            dn = factory(goals)
            self.episode += 1
            self.call = self.env_step = 0
            self.targets = set()
            if self.active:
                for t in self.plan():
                    self.targets.update((t, t + 1))
                    self.judged.append((self.episode, t))

            def denoise(states, actions, goals, sigma, **kw):
                if self.call % self.calls_per_step == 0 and self.active:
                    if self.tracer is not None:
                        self.tracer.tick(self.global_step)
                    self.global_step += 1
                out = dn(states, actions, goals, sigma, **kw)
                step = self.call // self.calls_per_step
                if self.active and step in self.targets:
                    self.calls.setdefault((self.episode, step), []).append(
                        tuple(t.clone() for t in (states, actions, goals, sigma, out)))
                self.call += 1
                return out

            return denoise

        return episode_factory

    def wrap_step(self, step_fn):
        def env_step(state, action, *args):
            new = step_fn(state, action, *args)
            if self.active and self.env_step in self.targets:
                self.steps[(self.episode, self.env_step)] = (
                    {f: getattr(state, f).clone() for f in _STATE_FIELDS}, action.clone(),
                    {f: getattr(new[0], f).clone() for f in _STATE_FIELDS})
            self.env_step += 1
            return new

        return env_step


class RolloutDriver:
    unit = "env_step"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.n_envs, self.n_steps = traffic["envs"], traffic["episode_steps"]
        self.sampler = traffic.get("sampler_type", cfg["sampler_type"])
        self.s_churn = float(traffic.get("s_churn", 0.0))
        self.n_sampling = cfg["n_timesteps"]
        if self.sampler not in ("ddim", "euler"):
            raise ValueError(f"the rollout driver judges ddim and euler, not {self.sampler!r}")
        self.cond_lambda = cfg["cond_lambda"]
        self.rows = self.n_envs * (2 if self.cond_lambda not in (0.0, 1.0) else 1)
        plan_rng = np.random.RandomState(inputs.numpy_seed(seed) ^ 0xCA97)
        W = cfg["window_size"]
        # steps kept for the comparison lie outside the traced slices, so
        # their counts do not depend on the seed
        lo = traffic["trace_start"] - 1
        hi = traffic["trace_start"] + traffic["trace_steps"] + traffic["trace_host_steps"]
        full = [t for t in range(W, self.n_steps - 1) if not lo <= t < hi]

        def plan():
            # one step while the windows fill, one once they are full
            return int(plan_rng.randint(0, W - 1)), int(full[plan_rng.randint(len(full))])

        self.capture = _Capture(self.n_sampling, plan)

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from beso_tpu_torch.agents.beso_agent import BesoAgent
        from beso_tpu_torch.data.trajectories import TrajectoryData
        from beso_tpu_torch.models.ema import ema_init
        from beso_tpu_torch.models.scaler import fit_scaler
        from beso_tpu_torch.rollout import rollout as rollout_mod
        from beso_tpu_torch.scripts.training import build_agent_config

        cfg, dev = self.cfg, self.device
        tc = time.perf_counter()
        torch.zeros((), device=dev)   # the device's context, timed on its own
        _sync(dev)
        t0 = time.perf_counter()
        self.data = inputs.synthetic_kitchen_data(self.traffic["data_trajectories"],
                                                  self.traffic["data_steps"], self.seed)
        data = TrajectoryData(*self.data)
        scaler = fit_scaler(data.all_observations(), data.all_actions(),
                            scale_data=cfg["scale_data"], device=dev)
        agent_cfg = build_agent_config(cfg)
        agent_cfg.inference_engine = self.traffic["engine"]
        agent = BesoAgent(agent_cfg, scaler, device=dev)
        t1 = time.perf_counter()
        # the program's own draws are overwritten below, so they are made on
        # the device rather than the host
        with torch.device(dev):
            agent.init(torch.Generator(dev).manual_seed(inputs.numpy_seed(self.seed)))
        t2 = time.perf_counter()
        self.weights = inputs.make_weights(cfg, self.seed, dev)
        model = agent.denoiser.inner_model
        model.load_state_dict(self.weights, strict=True)
        agent.state.ema = ema_init(model.named_parameters())
        self.policy_cfg = agent.policy_config(sampler_type=self.sampler,
                                              s_churn=self.s_churn or None)
        factory = self.capture.wrap_factory(agent.make_denoise_factory(self.policy_cfg))
        goals, expected = inputs.rollout_goals(self.data, self.n_envs,
                                               cfg["future_seq_length"], self.seed)
        self.goals = torch.as_tensor(goals, device=dev)
        self.expected = torch.as_tensor(expected, device=dev)
        self.generator = torch.Generator(dev).manual_seed(self.seed)
        self._rollout_mod = rollout_mod
        self._kitchen_step = rollout_mod.kitchen_step
        rollout_mod.kitchen_step = self.capture.wrap_step(rollout_mod.kitchen_step)

        def episode(n_steps):
            return rollout_mod.rollout_kitchen(
                agent.make_denoise_fn(), agent.scaler, self.policy_cfg, self.goals,
                self.expected, self.generator, n_steps=n_steps, denoise_factory=factory)

        self.agent, self.episode = agent, episode
        t3 = time.perf_counter()
        # warm-up: the cell's own shapes, one short episode
        episode(self.traffic["warmup_steps"])
        _sync(dev)
        self.setup_parts = {"device_context": t0 - tc, "data": t1 - t0, "agent_init": t2 - t1,
                            "weights_and_policy": t3 - t2, "warm_up": time.perf_counter() - t3}

    # -- the window --------------------------------------------------------
    def window(self, seconds: float, tracer=None) -> dict:
        self.capture.active, self.capture.tracer = True, tracer
        failed, ends = 0, []
        t0 = time.perf_counter()
        while True:
            m = self.episode(self.n_steps)
            _sync(self.device)
            ends.append(time.perf_counter())
            failed += int((~torch.isfinite(m.rewards)).sum())
            if ends[-1] - t0 >= seconds:
                break
        elapsed, episodes = ends[-1] - t0, len(ends)
        self.capture.active = False
        return {"env_steps": episodes * self.n_envs * self.n_steps, "episodes": episodes,
                "steps": episodes * self.n_steps,
                "window_s": elapsed, "attempted": episodes * self.n_envs, "failed": failed,
                "episode_s": [b - a for a, b in zip([t0] + ends, ends)]}

    def release(self) -> None:
        """Free the program's state and undo the physics wrapper."""
        self._rollout_mod.kitchen_step = self._kitchen_step
        self.agent = self.episode = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------
    def shapes(self) -> dict:
        W, G = self.cfg["window_size"], self.cfg["future_seq_length"]
        # the prefix cache serves grid samplers without churn (B1); every
        # other call runs the whole sequence (B4)
        return {"rows_per_call": self.rows, "calls_per_step": self.n_sampling,
                "cached": self.sampler == "ddim" and self.s_churn == 0.0,
                "suffix_tokens": 2 * W, "prefix_tokens": 1 + G,
                "tokens": 1 + G + 2 * W}

    def _ref_denoise(self, states, actions, goals, sigma, precision):
        out, n = [], 8192
        for i in range(0, states.shape[0], n):
            out.append(ref_model.denoise(self.weights, self.cfg, states[i:i + n],
                                         actions[i:i + n], goals[i:i + n],
                                         sigma[i:i + n], precision))
        return torch.cat(out)

    def _ref_goals(self, scaler):
        g = scaler.scale_input(self.goals)
        if self.rows == 2 * self.n_envs:
            return torch.cat([g, torch.zeros_like(g)])
        return g if self.cond_lambda != 0.0 else torch.zeros_like(g)

    def _ref_action(self, calls, t, scaler, precision):
        """The reference policy's env action at step t from the step's
        captured denoiser inputs."""
        B, W = self.n_envs, self.cfg["window_size"]
        goals = self._ref_goals(scaler)
        states = calls[0][0]
        if self.sampler == "ddim":
            grid = ref_sampling.exponential_grid(self.n_sampling, self.cfg["sigma_min"],
                                                 self.cfg["sigma_max"])
            x = calls[0][1][:B]
            for i in range(self.n_sampling):
                sig = torch.full((self.rows,), float(grid[i]), device=x.device)
                xx = torch.cat([x] * (self.rows // B))
                d = ref_sampling.cfg_combine(
                    self._ref_denoise(states, xx, goals, sig, precision), self.cond_lambda)
                x = ref_sampling.ddim_step(x, d, grid[i], grid[i + 1])
        else:  # euler: its last step, to sigma 0, from the last call's input
            x, sig = calls[-1][1][:B], calls[-1][3]
            s_hat = float(sig[0])
            d = ref_sampling.cfg_combine(
                self._ref_denoise(states, calls[-1][1], goals, sig, precision),
                self.cond_lambda)
            x = x + (x - d) / s_hat * (0.0 - s_hat)
        newest = min(t, W - 1)
        return scaler.inverse_scale_output(scaler.clip_action(x[:, newest]))

    def judge(self, precision: str = "f32") -> dict:
        """The numbers compared: with precision "f32" the program's outputs
        against the reference; with a lower precision the reference at that
        precision, put in the program's place (the control)."""
        set_exact_matmul()
        cfg, dev, B, W = self.cfg, self.device, self.n_envs, self.cfg["window_size"]
        scaler = ref_sampling.Scaler(self.data.valid(self.data.observations),
                                     self.data.valid(self.data.actions),
                                     cfg["scale_data"], dev)
        consts = ref_kitchen.Consts(dev)
        goals = self._ref_goals(scaler)
        init = ref_kitchen.reset(B, dev)
        engine, action, env, context, judged = 0.0, 0.0, 0.0, 0.0, 0
        with torch.no_grad():
            for ep, t in self.capture.judged:
                calls = self.capture.calls.get((ep, t))
                nxt = self.capture.calls.get((ep, t + 1))
                step = self.capture.steps.get((ep, t))
                step_next = self.capture.steps.get((ep, t + 1))
                if not calls or not nxt or step is None or step_next is None:
                    judged = 0   # a drawn step that never came: not correct
                    break
                judged += 1
                before, a_prog, after = step
                for states, actions, g, sigma, out in calls + nxt:
                    ref = self._ref_denoise(states, actions, goals, sigma, "f32")
                    cand = (out if precision == "f32" else
                            self._ref_denoise(states, actions, goals, sigma, precision))
                    engine = max(engine, float((cand - ref).abs().max() / ref.abs().max()))
                a_ref = self._ref_action(calls, t, scaler, "f32")
                a_cand = (a_prog if precision == "f32" else
                          self._ref_action(calls, t, scaler, precision))
                action = max(action, float((a_cand - a_ref).abs().max()))
                env_ref = ref_kitchen.step(before, a_prog, consts)
                env_cand = (after if precision == "f32" else
                            ref_kitchen.step(before, a_prog, consts, precision))
                for f in _STATE_FIELDS:
                    if env_cand[f].dtype.is_floating_point:
                        env = max(env, float((env_cand[f] - env_ref[f]).abs().max()))
                    elif not torch.equal(env_cand[f], env_ref[f]):
                        env = max(env, 1.0)
                # the program's own state, between the stages the reference follows
                states0 = calls[0][0][:B]
                ctx = [(states0[:, min(t, W - 1)], scaler.scale_input(before["qpos"])),
                       (calls[0][2], goals)]
                if self.s_churn == 0.0:
                    # the action context of step t + 1 (churn adds noise to
                    # every action token before the engine sees them)
                    prev = t if t + 1 < W else W - 2
                    ctx.append((nxt[0][1][:B, prev],
                                scaler.clip_action(scaler.scale_output(a_prog))))
                for f in _STATE_FIELDS:
                    ctx.append((step_next[0][f].float(), after[f].float()))
                if t == 0:
                    for f in _STATE_FIELDS:
                        ctx.append((before[f].float(), init[f].float()))
                    ctx.append((states0[:, 1:], torch.zeros_like(states0[:, 1:])))
                for got, want in ctx:
                    context = max(context, float((got - want).abs().max()))
        numbers = {"engine_gap": engine, "action_gap": action, "env_gap": env,
                   "context_gap": context}
        return numbers if judged else {k: float("inf") for k in numbers}
