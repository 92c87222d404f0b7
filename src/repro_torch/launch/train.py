"""Training driver of the port (``src/repro/launch/train.py``): the train
step (``lm_loss`` and its gradients by autograd, then AdamW), a
preemption-safe loop and compressed checkpoints, on one device or over
a rank mesh of several processes.

Run (reduced config, CPU):
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --reduced --steps 20 --batch 8 --seq 64 --device cpu
Over several processes (the launcher starts one a mesh position, gloo):
    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
        --reduced --steps 3 --batch 4 --seq 32 \
        --mesh pod=2,data=1,model=2 --device cpu

Everything runs on the card unless the caller passes ``--device cpu``
(``device='cpu'``); without a card that is an error, never a fallback.
On the card machine every rank computes on the one card (``cuda:0``) and
exchanges through the host (``runtime/dist.py``).
The state is the reference's tree, ``{"params", "opt": {"mu", "nu",
"step"}}`` (and ``"residual"`` where a pod axis asks for the compressed
exchange) with the same leaf paths, so each package restores the
other's checkpoint.

Over a rank mesh (``launch/mesh.py``) each rank keeps its shards of
every leaf (PARAM_RULES, ``runtime/sharding.py::place``) and takes its
block of the global batch's rows. The step gathers the shards on use to
whole leaves, takes the gradients of the loss over the rank's rows, then
their mean over the data group in rank order; with a pod axis and
``comp.enabled`` the compressed cross-pod exchange
(``optim/grad_compress.py::compressed_cross_pod_mean`` over the pod
group), else a plain mean over the pod group; then AdamW with the global
norm of the whole gradients, each rank updating its shards. MoE archs
exchange uncompressed and run expert-parallel over the model axis, as in
the reference. On a logical mesh (one process) the same step is
emulated position by position: each batch position's gradients on its
rows, the same means and exchange (``group=None``, the pods stacked on a
leading axis, the residual too), the same update; an MoE arch without
a model axis takes the global batch at once, as its ranks route it.
Serving over the same rank meshes: ``launch/serve.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..configs import get_arch
from ..convert import map_tree, tree_items
from ..data.synthetic import DataConfig, ShardedDataset, batch_rows
from ..models import transformer as T
from ..optim import (AdamWConfig, CompressionConfig, adamw_init,
                     adamw_update, compressed_cross_pod_mean, ef_init)
from ..optim.adamw import global_norm
from ..runtime.dist import launch, mean_ranks
from ..runtime.fused import target_device
from ..runtime.sharding import (ShardingPlan, gather_leaf, is_rank_plan,
                                leaf_sharding, make_plan, param_shardings,
                                place, plan_device)
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
    """The device a plan's mesh computes on (a rank's own on a rank
    mesh), else `device` (a card must be present for 'cuda')."""
    return plan_device(plan, "training") or target_device(device)


def _has_pod(plan: ShardingPlan) -> bool:
    return plan.mesh is not None and "pod" in plan.mesh.axis_names


def _pods(plan: ShardingPlan) -> int:
    return plan.axis_size("pod") if _has_pod(plan) else 1


def _nest(flat: Dict[str, torch.Tensor], like):
    """The flat {path: tensor} dict in `like`'s nesting."""
    return map_tree(lambda k, _v: flat[k], like)


def _logical_positions(plan: ShardingPlan) -> int:
    """Batch positions a logical mesh (one process) emulates in turn."""
    if plan.mesh is None or plan.mesh.is_rank_mesh:
        return 1
    return int(np.prod([plan.axis_size(a) for a in plan.batch_axes]))


def param_shapes(model_cfg) -> Dict[str, tuple]:
    """{path: whole shape} of the params tree (a meta init: nothing is
    drawn or allocated)."""
    return {k: tuple(v.shape) for k, v in tree_items(
        T.init_params(None, model_cfg, device="meta"))}


_PARAM_LIKE = ("params/", "opt/mu/", "opt/nu/", "residual/")


def state_shapes(model_cfg, state) -> Dict[str, tuple]:
    """{state path: whole shape} of a training state whose leaves may be
    one rank's shards: params, moments and residual take the params'
    shapes, the rest (the step) their own."""
    ps = param_shapes(model_cfg)
    out = {}
    for k, v in tree_items(state):
        head = next((h for h in _PARAM_LIKE if k.startswith(h)), None)
        out[k] = ps[k[len(head):]] if head else tuple(v.shape)
    return out


def state_shardings(state, plan: ShardingPlan, shapes=None):
    """{"params", "opt": {"mu", "nu", "step"}, ["residual"]} of
    {path: NamedSharding or None} by PARAM_RULES (the reference's
    ``state_shardings``), for a whole state or, with the params' whole
    `shapes` (:func:`param_shapes`), for one rank's shards of it."""
    ps = lambda t: param_shardings(t, plan, shapes=shapes)
    out = {"params": ps(state["params"]),
           "opt": {"mu": ps(state["opt"]["mu"]), "nu": ps(state["opt"]["nu"]),
                   "step": leaf_sharding("step", (), plan)}}
    if "residual" in state:
        out["residual"] = ps(state["residual"])
    return out


def init_state(key, model_cfg, train_cfg: TrainConfig, plan: ShardingPlan,
               device="cuda"):
    """Params drawn from `key` (a seed or a ``torch.Generator`` on the
    device), bf16 AdamW moments and step 0, and the error-feedback
    residual where the config and a pod axis ask for it.

    On a rank mesh every rank draws the same tree from the seed and keeps
    its shards of each leaf (:func:`runtime.sharding.place`); the
    moments and the residual are zeros shaped as the shards. On a logical
    mesh with a pod axis the residual holds every pod's, stacked on a
    leading axis."""
    dev = train_device(plan, device)
    params = T.init_params(key, model_cfg, device=dev)
    if is_rank_plan(plan):
        params = map_tree(lambda k, v: place(v, leaf_sharding(
            k, tuple(v.shape), plan)), params)
    flat = dict(tree_items(params))
    opt = adamw_init(flat, train_cfg.opt, device=dev)
    state = {"params": params,
             "opt": {"mu": _nest(opt["mu"], params),
                     "nu": _nest(opt["nu"], params), "step": opt["step"]}}
    if train_cfg.comp.enabled and _has_pod(plan):
        pods = 1 if is_rank_plan(plan) else _pods(plan)
        res = ef_init(flat, device=dev)
        if pods > 1:
            res = {k: v.expand((pods,) + tuple(v.shape)).clone()
                   for k, v in res.items()}
        state["residual"] = _nest(res, params)
    return state


def has_moe(model_cfg) -> bool:
    return any(b.mlp_kind == "moe" for u in model_cfg.units
               for b in u.blocks)


def _mean_in_order(parts):
    """The mean of equal-shaped tensors summed from 0 in order, as
    ``runtime/dist.py::mean_ranks`` takes it over a group (one part: that
    part, as a group of one)."""
    if len(parts) == 1:
        return parts[0]
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc = acc + p
    return acc / len(parts)


def _loss_and_grads(model_cfg, train_cfg, plan, flat, like, batch):
    """lm_loss of `batch` over the whole leaves `flat` and its gradients
    (zeros for a leaf the loss does not reach)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    loss, metr = T.lm_loss(_nest(leaves, like), model_cfg, batch, plan,
                           aux_weight=train_cfg.aux_weight)
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), got)}
    return loss.detach(), {k: v.detach() for k, v in metr.items()}, grads


def _opt_flat(state):
    return {"mu": dict(tree_items(state["opt"]["mu"])),
            "nu": dict(tree_items(state["opt"]["nu"])),
            "step": state["opt"]["step"]}


def _new_state(params, new_p, new_opt, new_res=None):
    out = {"params": _nest(new_p, params),
           "opt": {"mu": _nest(new_opt["mu"], params),
                   "nu": _nest(new_opt["nu"], params),
                   "step": new_opt["step"]}}
    if new_res is not None:
        out["residual"] = _nest(new_res, params)
    return out


def make_train_step(model_cfg, train_cfg: TrainConfig, plan: ShardingPlan,
                    device="cuda", keep_grads: bool = False):
    """-> train_step(state, batch) -> (new state, {"loss", "xent", "aux",
    "grad_norm", "lr"}). The gradients are ``torch.autograd.grad`` of
    ``lm_loss`` over the f32 param leaves, then ``adamw_update``. Over a
    rank mesh `state` holds the rank's shards and `batch` its rows; on a
    logical mesh of several batch positions `batch` is the global batch
    (module docstring). `keep_grads`: the metrics also hold "grads", the
    whole gradients AdamW took (after the means and the exchange)."""
    dev = train_device(plan, device)
    use_comp = train_cfg.comp.enabled and _has_pod(plan)
    if use_comp and has_moe(model_cfg):
        # the reference exchanges MoE archs uncompressed (its shard_map
        # nesting limit)
        use_comp = False
    if is_rank_plan(plan):
        return _rank_train_step(model_cfg, train_cfg, plan, dev, use_comp,
                                keep_grads)
    n_pos = _logical_positions(plan)
    # an MoE arch without a model axis routes its global batch at once on
    # the ranks (moe_apply's gather_rows), as the reference does: one
    # process takes that batch whole, not position by position
    if n_pos > 1 and not (plan.model_size == 1 and has_moe(model_cfg)):
        return _emulated_train_step(model_cfg, train_cfg, plan, dev,
                                    use_comp, n_pos, keep_grads)

    def train_step(state, batch):
        params = state["params"]
        flat = dict(tree_items(params))
        loss, metr, grads = _loss_and_grads(model_cfg, train_cfg, plan,
                                            flat, params, batch)
        new_p, new_opt, om = adamw_update(flat, grads, _opt_flat(state),
                                          train_cfg.opt, device=dev)
        return _new_state(params, new_p, new_opt), \
            _metrics(loss, metr, om, grads if keep_grads else None)

    return train_step


def _metrics(loss, metr, om, grads=None):
    out = {"loss": loss, **metr, **om}
    if grads is not None:
        out["grads"] = grads
    return out


def _rank_train_step(model_cfg, train_cfg, plan, dev, use_comp, keep_grads):
    mesh = plan.mesh
    data_g = mesh.group([a for a in ("data",) if a in mesh.axis_names])
    pod_g = mesh.group([a for a in ("pod",) if a in mesh.axis_names])

    shd = {k: leaf_sharding(k, shape, plan)
           for k, shape in param_shapes(model_cfg).items()}

    def train_step(state, batch):
        params = state["params"]
        shards = dict(tree_items(params))
        # gather on use: the whole leaves, then the one-device step on
        # this rank's rows
        whole = {k: gather_leaf(v, shd[k]) for k, v in shards.items()}
        like = _nest(whole, params)
        loss, metr, grads = _loss_and_grads(model_cfg, train_cfg, plan,
                                            whole, like, batch)
        del whole, like
        grads = {k: mean_ranks(g, data_g) for k, g in grads.items()}
        loss = mean_ranks(mean_ranks(loss, data_g), pod_g)
        metr = {k: mean_ranks(mean_ranks(v, data_g), pod_g)
                for k, v in metr.items()}
        new_res = None
        if use_comp:
            # leaf by leaf: one whole residual at a time
            new_res = {}
            for k, r in tree_items(state["residual"]):
                mean, r = compressed_cross_pod_mean(
                    {k: grads[k]}, {k: gather_leaf(r, shd[k])},
                    train_cfg.comp, group=pod_g, device=dev)
                grads[k] = mean[k]
                new_res[k] = place(r[k], shd[k])
                del mean, r
        else:
            grads = {k: mean_ranks(g, pod_g) for k, g in grads.items()}
        gn = global_norm(grads)
        kept = grads if keep_grads else None
        grads = {k: place(g, shd[k]) for k, g in grads.items()}
        new_p, new_opt, om = adamw_update(shards, grads, _opt_flat(state),
                                          train_cfg.opt, device=dev,
                                          grad_norm=gn)
        return _new_state(params, new_p, new_opt, new_res), \
            _metrics(loss, metr, om, kept)

    return train_step


def _emulated_train_step(model_cfg, train_cfg, plan, dev, use_comp, n_pos,
                         keep_grads):
    """The rank step of a mesh emulated in one process (a logical mesh):
    each batch position's gradients on its rows under a plan of one batch
    position (the model axis kept), the mean over data in order, the pod
    exchange with the pods stacked (``group=None``), AdamW."""
    pods = _pods(plan)
    per_pod = n_pos // pods
    ms = plan.model_size
    pos_plan = make_plan_for(model_cfg, mesh_lib.make_mesh(
        (1, ms), ("data", "model"), devices=[dev] * ms))

    def train_step(state, batch):
        params = state["params"]
        flat = dict(tree_items(params))
        losses, metrs, pod_grads = [], [], []
        for p in range(pods):
            g_data = []
            for d in range(per_pod):
                rows = batch_rows(batch, p * per_pod + d, n_pos)
                loss, metr, g = _loss_and_grads(model_cfg, train_cfg,
                                                pos_plan, flat, params, rows)
                losses.append(loss)
                metrs.append(metr)
                g_data.append(g)
            pod_grads.append({k: _mean_in_order([g[k] for g in g_data])
                              for k in flat})
        loss = _mean_in_order([_mean_in_order(losses[p * per_pod:
                                                     (p + 1) * per_pod])
                               for p in range(pods)])
        metr = {k: _mean_in_order([_mean_in_order(
            [m[k] for m in metrs[p * per_pod:(p + 1) * per_pod]])
            for p in range(pods)]) for k in metrs[0]}
        new_res = None
        if use_comp:
            stacked = {k: torch.stack([g[k] for g in pod_grads])
                       for k in flat}
            grads, new_res = compressed_cross_pod_mean(
                stacked, dict(tree_items(state["residual"])),
                train_cfg.comp, device=dev)
        else:
            grads = {k: _mean_in_order([g[k] for g in pod_grads])
                     for k in flat}
        new_p, new_opt, om = adamw_update(flat, grads, _opt_flat(state),
                                          train_cfg.opt, device=dev)
        return _new_state(params, new_p, new_opt, new_res), \
            _metrics(loss, metr, om, grads if keep_grads else None)

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
    (state, [(step, loss)] at every `log_every` steps and the last).
    Over a rank mesh the state is the rank's shards, each batch the
    rank's rows of the global batch, the checkpoint one stream written
    by rank 0 (``checkpoint/ckpt.py``), and rank 0 prints."""
    from ..checkpoint import ckpt as C
    dev = train_device(plan, device)
    state = start_state or init_state(data_cfg.seed, model_cfg, train_cfg,
                                      plan, device=dev)
    ranks = is_rank_plan(plan)
    ds = ShardedDataset(data_cfg, start_step=start_step,
                        block=plan.batch_index() if ranks else None)
    step_fn = make_train_step(model_cfg, train_cfg, plan, device=dev)
    loud = not ranks or plan.mesh.rank == 0
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
                if loud:
                    print(f"step {i:5d} loss {loss:9.4f} "
                          f"gnorm {float(metrics['grad_norm']):8.3f} "
                          f"({(time.time() - t0):6.1f}s)", flush=True)
            should_ckpt = ckpt_dir and (
                (i + 1) % ckpt_every == 0 or i == steps - 1 or stopper.stop)
            if should_ckpt:
                C.save_checkpoint(
                    ckpt_dir, state, step=i + 1, extra={"data": ds.state()},
                    device=dev, plan=plan if ranks else None,
                    shapes=state_shapes(model_cfg, state) if ranks else None)
            if stopper.stop:
                if loud:
                    print(f"preemption signal: checkpointed at step "
                          f"{i + 1}, exiting cleanly", flush=True)
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
    decode on that device. Over a rank mesh each rank keeps its shards
    (a checkpoint saved from any mesh restores onto any other)."""
    from ..checkpoint import ckpt as C
    dev = train_device(plan, device)
    restored = C.restore_checkpoint(ckpt_dir, step=step, plan=plan,
                                    device=dev)
    if restored is None:
        return None
    state, meta = restored
    return map_tree(lambda _k, x: _leaf_on(x, dev), state), meta


def _main_rank(rank: int, argv):
    """One rank of :func:`main` under the launcher: its rank-0 history."""
    _, history = main(argv)
    return history


def main(argv=None, callback: Optional[Callable] = None):
    """The training CLI. With ``--mesh`` of several positions outside a
    ``torch.distributed`` world it starts one process a position
    (``runtime/dist.py::launch``, gloo) and returns (None, rank 0's
    history); inside a world (each such process) it trains over the rank
    mesh. Else -> (state, history)."""
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
                    help="e.g. 'pod=2,data=1,model=2', or '2x2' => "
                         "(data=2, model=2): one process a position")
    ap.add_argument("--timeout", type=float, default=3600,
                    help="seconds the launched processes may take")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; a card must be present) or 'cpu'")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    model_cfg = spec.reduced() if args.reduced else spec.config()
    dev = target_device(args.device)
    mesh = None
    if args.mesh:
        dims, names = mesh_lib.parse_mesh(args.mesh)
        n = int(np.prod(dims))
        if n > 1 and mesh_lib._world() is None:
            if callback is not None:
                raise ValueError("a callback cannot follow the ranks of a "
                                 "launched mesh")
            res = launch(_main_rank, n, args=(argv,),
                         timeout=args.timeout, echo=True)
            return None, res[0].result
        mesh = mesh_lib.make_mesh(
            dims, names, devices=[dev] * n if dev.type != "cuda" else None)
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
            if not is_rank_plan(plan) or plan.mesh.rank == 0:
                print(f"resumed from step {start_step}")
    return train_loop(model_cfg, data_cfg, train_cfg, plan, args.steps,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      start_state=start_state, start_step=start_step,
                      device=dev, callback=callback)


if __name__ == "__main__":
    main()
