"""Training driver of the port (``src/repro/launch/train.py``) on one
device: the train step (``lm_loss`` and its gradients by autograd, then
AdamW), a preemption-safe loop and compressed checkpoints.

Run (reduced config, CPU):
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --reduced --steps 20 --batch 8 --seq 64 --device cpu

Everything runs on the card unless the caller passes ``--device cpu``
(``device='cpu'``); without a card that is an error, never a fallback.
The state is the reference's tree, ``{"params", "opt": {"mu", "nu",
"step"}}`` (and ``"residual"`` where a pod axis asks for the compressed
exchange) with the same leaf paths, so each package restores the
other's checkpoint. The compressed cross-pod exchange inside the step,
and placement over several devices, are not ported yet (ROADMAP Queue 1
item 5c): such a plan raises NotImplementedError.
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..configs import get_arch
from ..convert import map_tree, tree_items
from ..data.synthetic import DataConfig, ShardedDataset
from ..models import transformer as T
from ..optim import (AdamWConfig, CompressionConfig, adamw_init,
                     adamw_update, ef_init)
from ..runtime.fused import target_device
from ..runtime.sharding import ShardingPlan, make_plan, plan_device
from . import mesh as mesh_lib


@dataclasses.dataclass
class TrainConfig:
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    comp: CompressionConfig = dataclasses.field(
        default_factory=CompressionConfig)
    aux_weight: float = 0.01


def make_plan_for(model_cfg, mesh) -> ShardingPlan:
    plan = make_plan(mesh)
    # pick heads vs head_dim TP per arch (see ShardingPlan.attn_part)
    n_heads = None
    for u in model_cfg.units:
        for b in u.blocks:
            if b.kind == "attn":
                n_heads = b.attn.n_heads
            elif b.kind == "mla":
                n_heads = b.mla.n_heads
    if n_heads is not None and plan.mesh is not None \
       and n_heads % plan.model_size != 0:
        plan = dataclasses.replace(plan, attn_part="head_dim")
    return plan


def train_device(plan: ShardingPlan, device="cuda") -> torch.device:
    """The device a plan's mesh spans, else `device` (a card must be
    present for 'cuda'); a mesh over several devices raises."""
    return plan_device(plan, "training") or target_device(device)


def _has_pod(plan: ShardingPlan) -> bool:
    return plan.mesh is not None and "pod" in plan.mesh.axis_names


def _nest(flat: Dict[str, torch.Tensor], like):
    """The flat {path: tensor} dict in `like`'s nesting."""
    return map_tree(lambda k, _v: flat[k], like)


def init_state(key, model_cfg, train_cfg: TrainConfig, plan: ShardingPlan,
               device="cuda"):
    """Params drawn from `key` (a seed or a ``torch.Generator`` on the
    device), bf16 AdamW moments and step 0, and the error-feedback
    residual where the config and a pod axis ask for it."""
    dev = train_device(plan, device)
    params = T.init_params(key, model_cfg, device=dev)
    flat = dict(tree_items(params))
    opt = adamw_init(flat, train_cfg.opt, device=dev)
    state = {"params": params,
             "opt": {"mu": _nest(opt["mu"], params),
                     "nu": _nest(opt["nu"], params), "step": opt["step"]}}
    if train_cfg.comp.enabled and _has_pod(plan):
        state["residual"] = _nest(ef_init(flat, device=dev), params)
    return state


def has_moe(model_cfg) -> bool:
    return any(b.mlp_kind == "moe" for u in model_cfg.units
               for b in u.blocks)


def make_train_step(model_cfg, train_cfg: TrainConfig, plan: ShardingPlan,
                    device="cuda"):
    """-> train_step(state, batch) -> (new state, {"loss", "xent", "aux",
    "grad_norm", "lr"}). The gradients are ``torch.autograd.grad`` of
    ``lm_loss`` over the f32 param leaves, then ``adamw_update``."""
    dev = train_device(plan, device)
    use_comp = train_cfg.comp.enabled and _has_pod(plan)
    if use_comp and has_moe(model_cfg):
        # the reference exchanges MoE archs uncompressed (its shard_map
        # nesting limit)
        use_comp = False
    if use_comp:
        raise NotImplementedError(
            "the compressed cross-pod gradient exchange inside the train "
            f"step (a pod axis in mesh {plan.mesh.shape}) is not ported to "
            "repro_torch yet (ROADMAP Queue 1 item 5c)")

    def train_step(state, batch):
        params = state["params"]
        flat = dict(tree_items(params))
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flat.items()}
        loss, metr = T.lm_loss(_nest(leaves, params), model_cfg, batch,
                               plan, aux_weight=train_cfg.aux_weight)
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), got)}
        del leaves, got
        opt = {"mu": dict(tree_items(state["opt"]["mu"])),
               "nu": dict(tree_items(state["opt"]["nu"])),
               "step": state["opt"]["step"]}
        new_p, new_opt, om = adamw_update(flat, grads, opt, train_cfg.opt,
                                          device=dev)
        new_state = {"params": _nest(new_p, params),
                     "opt": {"mu": _nest(new_opt["mu"], params),
                             "nu": _nest(new_opt["nu"], params),
                             "step": new_opt["step"]}}
        metrics = {"loss": loss.detach(), "xent": metr["xent"].detach(),
                   "aux": metr["aux"].detach(), **om}
        return new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# preemption-safe training loop
# ---------------------------------------------------------------------------

class GracefulStop:
    """SIGTERM/SIGINT => finish the current step, checkpoint, exit.

    This is the node-preemption story: orchestrators deliver SIGTERM with a
    grace window; we always leave a restartable checkpoint behind.
    :meth:`close` puts the previous handlers back."""

    def __init__(self):
        self.stop = False
        self._old = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass  # not main thread (tests)

    def _handler(self, *_):
        self.stop = True

    def close(self):
        for sig, old in self._old.items():
            signal.signal(sig, old)
        self._old = {}


def batch_on(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch of ``batch_for_step`` as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def train_loop(model_cfg, data_cfg: DataConfig, train_cfg: TrainConfig,
               plan: ShardingPlan, steps: int, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 100, log_every: int = 10,
               start_state: Optional[Dict] = None, start_step: int = 0,
               device="cuda", callback: Optional[Callable] = None):
    """Steps start_step..steps-1 from `start_state` (else a state drawn
    from data_cfg.seed), checkpointing into `ckpt_dir` every `ckpt_every`
    steps, at the last step and on a stop signal (then returning). The
    data iterator starts at `start_step` (a checkpoint's data step is
    its step); `callback(i, state, metrics, batch)` sees every step. ->
    (state, [(step, loss)] at every `log_every` steps and the last)."""
    from ..checkpoint import ckpt as C
    dev = train_device(plan, device)
    state = start_state or init_state(data_cfg.seed, model_cfg, train_cfg,
                                      plan, device=dev)
    ds = ShardedDataset(data_cfg, start_step=start_step)
    step_fn = make_train_step(model_cfg, train_cfg, plan, device=dev)
    stopper = GracefulStop()
    history = []
    t0 = time.time()
    try:
        for i in range(start_step, steps):
            batch = batch_on(next(ds), dev)
            state, metrics = step_fn(state, batch)
            if callback is not None:
                callback(i, state, metrics, batch)
            if i % log_every == 0 or i == steps - 1:
                loss = float(metrics["loss"])
                history.append((i, loss))
                print(f"step {i:5d} loss {loss:9.4f} "
                      f"gnorm {float(metrics['grad_norm']):8.3f} "
                      f"({(time.time() - t0):6.1f}s)", flush=True)
            should_ckpt = ckpt_dir and (
                (i + 1) % ckpt_every == 0 or i == steps - 1 or stopper.stop)
            if should_ckpt:
                C.save_checkpoint(ckpt_dir, state, step=i + 1,
                                  extra={"data": ds.state()}, device=dev)
            if stopper.stop:
                print(f"preemption signal: checkpointed at step {i + 1}, "
                      "exiting cleanly", flush=True)
                break
    finally:
        stopper.close()
    return state, history


def _leaf_on(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


def restore_state(ckpt_dir: str, plan: ShardingPlan, device="cuda",
                  step: Optional[int] = None):
    """The newest (or the given) step of a training checkpoint with every
    leaf on the training device -> (state, meta) or None. Lossy leaves
    decode on that device."""
    from ..checkpoint import ckpt as C
    dev = train_device(plan, device)
    restored = C.restore_checkpoint(ckpt_dir, step=step, plan=plan,
                                    device=dev)
    if restored is None:
        return None
    state, meta = restored
    return map_tree(lambda _k, x: _leaf_on(x, dev), state), meta


def main(argv=None, callback: Optional[Callable] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="e.g. '2x2' => (data=2, model=2) mesh")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; a card must be present) or 'cpu'")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    model_cfg = spec.reduced() if args.reduced else spec.config()
    dev = target_device(args.device)
    mesh = None
    if args.mesh:
        dims = [int(x) for x in args.mesh.split("x")]
        names = ("pod", "data", "model")[-len(dims):]
        # the CPU: a logical mesh on it; the card: one card an entry
        mesh = mesh_lib.make_mesh(
            dims, names, devices=None if dev.type == "cuda"
            else [dev] * int(np.prod(dims)))
    plan = make_plan_for(model_cfg, mesh)
    dev = train_device(plan, dev)
    text = args.seq - (model_cfg.frontend_len
                       if model_cfg.frontend == "vision" else 0)
    data_cfg = DataConfig(
        vocab_size=model_cfg.vocab_size, global_batch=args.batch,
        seq_len=text,
        frontend=model_cfg.frontend,
        frontend_len=(model_cfg.encoder.n_frames if model_cfg.encoder
                      else model_cfg.frontend_len),
        frontend_dim=model_cfg.d_model)
    train_cfg = TrainConfig()
    start_state, start_step = None, 0
    if args.resume and args.ckpt_dir:
        restored = restore_state(args.ckpt_dir, plan, dev)
        if restored is not None:
            start_state, meta = restored
            start_step = meta["step"]
            print(f"resumed from step {start_step}")
    return train_loop(model_cfg, data_cfg, train_cfg, plan, args.steps,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      start_state=start_state, start_step=start_step,
                      device=dev, callback=callback)


if __name__ == "__main__":
    main()
