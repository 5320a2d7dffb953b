"""What the traffic kinds share. A mix file (``traffic/<mix>.json``) names
its ``kind``; the harness loads ``kinds/<kind>.py`` by that name, whose
``KIND`` is a subclass of ``Generate`` or ``Train`` here; a configuration
file (``configs/<config>.json``) gives the model. A new kind is a new file
in ``kinds/``.

A generation window holds whole calls: a call starts only while the window's
clock is under its seconds, the one in flight is finished. A training window
runs steps while the clock is under its seconds and ends with a
synchronisation after the last. Both read the card's energy counter at their
two ends. Every denoise step's time comes from CUDA events that a forward
pre-hook on the network records (it neither waits nor copies to the host);
the first step of a call runs from the call's start event, the last to the
event after the sampler returns.

Inputs of the timed path are drawn on the device from the seed (stream
``TRAFFIC``): start noise; batch rows (a permutation of the pool, a new one
when it runs out, so the rows of the first steps all differ), timesteps and
noise. Every kind also keeps what its judge needs: the generation kinds the
input and ε of a few steps of every call (drawn from the seed, the last
step always among them) and each call's output; the training kinds
the first three steps' batches, the first moment after step 1 and the
parameters after step 3, which set-up runs through the window's own step
call before handing the same state to the window.

The program's modules are built on the card (``torch.device`` as the
default device), where PyTorch's default initialisation, which the seed's
weights then replace, costs a few launches instead of host time.
"""

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mrijax_torch.diffusion import (
    GaussianDiffusion,
    cosine_beta_schedule,
    linear_beta_schedule,
    make_schedule,
)
from mrijax_torch.train.state import create_train_state

from benchmark_h100 import judge, seeding, tracing
from benchmark_h100.count import ops
from benchmark_h100.reference import diffusion as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
BETAS = {"cosine": cosine_beta_schedule, "linear": linear_beta_schedule}
UNET3D_KEYS = ("in_channels", "base_channels", "channel_mults", "time_emb_dim", "groups",
               "num_heads", "use_attention", "attention_levels")
UNET2D_KEYS = ("in_channels", "out_channels", "base_channels", "channel_mults",
               "time_emb_dim", "groups")
VAE_KEYS = ("in_channels", "base_channels", "num_down", "latent_channels")
WARMUP = 6   # stream of the warm-up's inputs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _HostEvent:
    """A CUDA event's interface on the host clock, for the CPU."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def _event(device: torch.device):
    e = torch.cuda.Event(enable_timing=True) if device.type == "cuda" else _HostEvent()
    e.record()
    return e


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _kw(section: dict, keys) -> dict:
    return {k: (tuple(section[k]) if isinstance(section[k], list) else section[k])
            for k in keys if k in section}


def set_reference_precision() -> None:
    """Plain float32 for the reference: no TF32 in products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Traffic:
    role = ""

    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device,
                 trace: bool = False, energy=None):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device, self.trace, self.energy = device, trace, energy
        self.dtype = DTYPES[config["compute_dtype"]]
        d = config["diffusion"]
        self.timesteps = d["timesteps"]
        self.schedule = make_schedule(BETAS[d["schedule"]](self.timesteps))
        self.g = seeding.generator(seed, seeding.TRAFFIC, device)
        self.rng = seeding.check_rng(seed)
        self.marks = [("start", time.perf_counter())]

    def mark(self, what: str) -> None:
        """Note the host clock at the end of a part of set-up."""
        _sync(self.device)
        self.marks.append((what, time.perf_counter()))

    def _energy(self) -> Optional[float]:
        return None if self.energy is None else self.energy.energy_j()

    def counts(self) -> dict:
        """Operations and kernel work of one unit, from the reference on the
        meta device (``count.ops``)."""
        raise NotImplementedError


# ------------------------------------------------------------------ generation


class Generate(Traffic):
    """What both generation kinds share: the hooks, the window of whole
    calls, the traced segment and the step-by-step judge."""

    role = "gen"
    net: torch.nn.Module

    def _install_hooks(self) -> None:
        self.cur = None
        self.segment = None
        self.net.register_forward_pre_hook(self._pre)
        self.net.register_forward_hook(self._post)

    def _pre(self, mod, args):
        if self.segment is not None:
            self.segment.unit()
        call = self.cur
        if call is None:
            return
        call["events"].append(_event(self.device))
        k = self.k
        if k in call["want"]:
            call["x"][k] = args[0].clone()
        if k - 1 in call["want"]:
            call["next"][k - 1] = args[0].clone()
        self.k += 1

    def _post(self, mod, args, out):
        call = self.cur
        if call is not None and self.k - 1 in call["want"]:
            call["eps"][self.k - 1] = out.clone()

    def _steps(self) -> np.ndarray:
        return ref.ddim_timesteps(self.timesteps, self.mix["ddim_steps"])

    def window(self, seconds: float, min_calls: int = 0) -> dict:
        n = len(self._steps())
        k_check = min(self.mix["check"]["steps"], n)
        denoise_s = decode_s = 0.0
        calls: List[dict] = []
        _sync(self.device)
        e0 = self._energy()
        t0 = time.perf_counter()
        with torch.no_grad():
            while time.perf_counter() - t0 < seconds or len(calls) < min_calls:
                want = set(self.rng.choice(n - 1, k_check - 1, replace=False).tolist()) | {n - 1}
                call = {"want": want, "x": {}, "eps": {}, "next": {}, "events": []}
                x_t = torch.randn(self.shape, generator=self.g, device=self.device)
                if self.trace:
                    _sync(self.device)
                    d0 = time.perf_counter()
                self.cur, self.k = call, 0
                call["events"].append(_event(self.device))
                z = self.denoise(x_t)
                call["events"].append(_event(self.device))
                self.cur = None
                call["next"][n - 1] = z
                if self.trace:
                    _sync(self.device)
                    d1 = time.perf_counter()
                    denoise_s += d1 - d0
                call["out"] = self.finish(z)
                if self.trace:
                    _sync(self.device)
                    decode_s += time.perf_counter() - d1
                calls.append(call)
        _sync(self.device)
        t1 = time.perf_counter()
        e1 = self._energy()
        step_ms = []
        for call in calls:
            ev = call.pop("events")
            # ev[0]: the call's start; ev[1]: the first step's own start (unused);
            # ev[2 …]: the later steps' starts; ev[-1]: after the sampler returned
            bounds = [ev[0]] + ev[2:]
            step_ms += [a.elapsed_time(b) for a, b in zip(bounds[:-1], bounds[1:])]
        samples = len(calls) * self.per_call
        failed = sum(self.per_call for c in calls if not bool(torch.isfinite(c["out"]).all()))
        self.calls = calls
        return {"seconds": t1 - t0, "samples": samples, "attempted": samples,
                "failed": failed, "calls": len(calls), "steps": len(step_ms),
                "step_ms": step_ms, "forwards": len(calls) * n,
                "energy_j": None if e0 is None else e1 - e0,
                "denoise_s": denoise_s if self.trace else None,
                "decode_s": decode_s if self.trace else None}

    def release(self) -> None:
        """Free the program; keep the checked calls' captures."""
        picked = self.rng.choice(len(self.calls), min(self.mix["check"]["calls"], len(self.calls)),
                                 replace=False)
        self.checked = [self.calls[i] for i in sorted(picked.tolist())]
        self.calls = None
        for name in self.program_attrs:
            setattr(self, name, None)
        _free(self.device)

    def _unet_ref(self, p, x, t, prec):
        raise NotImplementedError

    def judge(self, control: bool = False) -> Dict[str, float]:
        """The numbers of the checked calls; ``control``: the reference in
        float8 (its DDIM update in bfloat16) in the program's place."""
        set_reference_precision()
        dev = self.device
        p = seeding.make_weights(self.net_spec, self.seed, seeding.WEIGHTS_UNET, dev)
        acp = ref.alphas_cumprod(self.config["diffusion"]["schedule"], self.timesteps, dev)
        seq = self._steps().tolist()
        seq_prev = seq[1:] + [0]
        unet_err = ddim_err = 0.0
        with torch.no_grad():
            for call in self.checked:
                for k in sorted(call["want"]):
                    x = call["x"][k].float()
                    t = torch.full((x.shape[0],), seq[k], dtype=torch.long, device=dev)
                    eps_r = self._unet_ref(p, x, t, "fp32")
                    eps_p, nxt = call["eps"][k].float(), call["next"][k].float()
                    if control:
                        eps_p = self._unet_ref(p, x, t, "fp8")
                        nxt = ref.ddim_update(acp, x, eps_p, seq[k], seq_prev[k], torch.bfloat16)
                    unet_err = max(unet_err, judge.rel_rows(eps_p, eps_r))
                    ddim_err = max(ddim_err, judge.rel_rows(
                        nxt, ref.ddim_update(acp, x, eps_p, seq[k], seq_prev[k])))
                    del eps_r, eps_p, nxt
        numbers = {"unet_rel_err": unet_err, "ddim_rel_err": ddim_err}
        numbers.update(self._judge_output(control))
        return numbers

    def _judge_output(self, control: bool) -> Dict[str, float]:
        return {}

    def segment_trace(self) -> Optional[dict]:
        prof = self.mix["profile"]
        self.segment = tracing.Segment(self.device, prof["skip"], prof["active"])
        with torch.no_grad():
            self.traced_denoise()
        self.segment, out = None, self.segment.finish()
        return out


# -------------------------------------------------------------------- training


class Train(Traffic):
    """What both training kinds share: the pool, the feed, the first three
    steps kept for the judge, the window and the traced segment."""

    role = "train"
    FIRST = 3

    def setup(self) -> None:
        c, dev = self.config, self.device
        self.batch = self.mix["batch"]
        with dev:
            self.net = self.build()
        self.mark("modules")
        self.net_spec = seeding.param_spec(self.net)
        seeding.load_weights(self.net, seeding.make_weights(
            self.net_spec, self.seed, seeding.WEIGHTS_UNET, dev))
        self.mark("weights")
        self.lr = c["train"]["learning_rate"]
        self.state = create_train_state(self.net, self.lr, device=dev)
        self.mark("optimizer")   # torch.optim.Adam's first construction imports torch._dynamo
        d = c["diffusion"]
        diffusion = GaussianDiffusion(self.schedule, loss_type=d["loss_type"],
                                      min_snr_gamma=d.get("min_snr_gamma", 5.0))
        self.step_fn = self.make_step(diffusion)
        self.make_pool()
        self.mark("pool")
        self.order, self.at = None, 0
        # the first steps, through the window's own call and feed, on the
        # state the window goes on with
        self.first, self.losses_p = [], []
        for i in range(self.FIRST):
            b = self.next_batch()
            self.first.append(b)
            _, loss = self.call(b)
            self.losses_p.append(loss)
            if i == 0:
                beta1 = self.state.optimizer.param_groups[0]["betas"][0]
                opt_state = self.state.optimizer.state
                # a parameter Adam never stepped has no moment: nought
                self.grad_p = {
                    name: opt_state[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in opt_state[p]
                    else torch.zeros_like(p) for name, p in self.net.named_parameters()}
        self.after_p = {name: p.detach().clone() for name, p in self.net.named_parameters()}
        self.mark("first steps")

    def next_batch(self) -> dict:
        n = self.pool.shape[0]
        if self.order is None or self.at + self.batch > n:
            self.order = torch.randperm(n, generator=self.g, device=self.device)
            self.at = 0
        idx = self.order[self.at:self.at + self.batch]
        self.at += self.batch
        t = torch.randint(self.t_min, self.timesteps, (self.batch,), generator=self.g,
                          device=self.device)
        noise = torch.randn((self.batch, *self.pool.shape[1:]), generator=self.g,
                            device=self.device)
        return {"idx": idx, "t": t, "noise": noise}

    def window(self, seconds: float, min_calls: int = 0) -> dict:
        host_s, losses = [], []
        _sync(self.device)
        e0 = self._energy()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or len(losses) < min_calls:
            b = self.next_batch()
            h0 = time.perf_counter()
            _, loss = self.call(b)
            host_s.append(time.perf_counter() - h0)
            losses.append(loss)
        _sync(self.device)
        t1 = time.perf_counter()
        e1 = self._energy()
        steps = len(losses)
        failed = 0 if not losses else int((~torch.isfinite(torch.stack(losses))).sum())
        return {"seconds": t1 - t0, "samples": steps * self.batch, "steps": steps,
                "attempted": steps, "failed": failed, "step_host_s": host_s,
                "energy_j": None if e0 is None else e1 - e0}

    def segment_trace(self) -> Optional[dict]:
        prof = self.mix["profile"]
        seg = tracing.Segment(self.device, prof["skip"], prof["active"])
        for _ in range(prof["skip"] + prof["active"]):
            b = self.next_batch()
            seg.unit()
            self.call(b)
        return seg.finish()

    def release(self) -> None:
        """Free the program; the pool, which both sides read, stays."""
        self.losses_p = [float(x) for x in self.losses_p]
        self.state = self.step_fn = self.net = self.order = None
        _free(self.device)

    def reference(self, prec: str):
        """The reference's first three steps from the seed's weights:
        (losses, first gradient by leaf, change's leaf norms)."""
        set_reference_precision()
        dev = self.device
        p0 = seeding.make_weights(self.net_spec, self.seed, seeding.WEIGHTS_UNET, dev)
        params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        names = list(params)
        adam = ref.Adam(params, self.lr)
        acp = ref.alphas_cumprod(self.config["diffusion"]["schedule"], self.timesteps, dev)
        d = self.config["diffusion"]
        losses, first_grads = [], None
        for i, b in enumerate(self.first):
            grads = {k: torch.zeros_like(v) for k, v in params.items()}
            total = 0.0
            for rows in ref.chunks(self.batch, self.mix["check"]["micro_batch"]):
                x0 = self.rows(b["idx"][rows])
                t, noise = b["t"][rows], b["noise"][rows]
                eps = self.forward_ref(params, ref.q_sample(acp, x0["x"], t, noise), t, x0, prec)
                term = ref.loss_terms(d["loss_type"], acp, eps, noise, t,
                                      d.get("min_snr_gamma", 5.0)).sum() / self.batch
                for k, g in zip(names, torch.autograd.grad(term, [params[k] for k in names],
                                                           allow_unused=True)):
                    if g is not None:
                        grads[k] += g
                total += float(term.detach())
                del eps, term
            losses.append(total)
            if i == 0:
                first_grads = {k: g.clone() for k, g in grads.items()}
            adam.step(grads)
            del grads
        delta = judge.leaf_norms({k: params[k].detach() - p0[k] for k in names})
        return losses, first_grads, delta

    def judge(self, control: bool = False) -> Dict[str, float]:
        losses_r, grad_r, delta_r = self.reference("fp32")
        if control:
            losses_p, grad_p, delta_p = self.reference("fp8")
        else:
            p0 = seeding.make_weights(self.net_spec, self.seed, seeding.WEIGHTS_UNET, self.device)
            losses_p, grad_p = self.losses_p, self.grad_p
            delta_p = judge.leaf_norms({k: self.after_p[k] - p0[k] for k in p0})
        self.readings = (losses_p, losses_r, grad_p, grad_r, delta_p, delta_r)
        return judge.train_numbers(*self.readings)

    def counts(self) -> dict:
        meta = seeding.make_weights(self.net_spec, 0, 0, "meta")
        with ops.counting() as unit:
            self.forward_ref(meta, torch.empty((self.batch, *self.sample_shape), device="meta"),
                             torch.zeros(self.batch, dtype=torch.long, device="meta"),
                             {"z": torch.zeros(self.batch, device="meta")}, "fp32")
        return {"forward": unit}
