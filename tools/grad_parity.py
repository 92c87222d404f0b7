#!/usr/bin/env python3
"""The training loss's gradients in the port against the reference's, and
the reference against itself, for each arch's reduced config. Runs on the
CPU, through the JAX reference and the port, with the same parameters
and batch.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/grad_parity.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/grad_parity.py \\
        --arch zamba2-7b --seeds 0 3 [--ssd-f32]

For each arch and seed: the reference's params at ``jax.random.key(seed)``
carried to the port (``convert.tree_from_reference``), a
``batch_for_step`` batch of 2 x 32 tokens from the same seed, both
packages computing in f32 (``COMPUTE_DTYPE``). It prints the loss's
relative difference, the gradient leaf with the largest relative L2
error between the packages, and the reference's own spread: the largest
relative L2 change of its gradients when every parameter moves by one
f32 ulp (a seeded sign each). Where the spread is above 2^-7 an error of
one bf16 rounding cannot be held between two implementations.
``--ssd-f32`` runs mamba2's ``ssd_chunked`` with its explicit bf16 in
f32 on both sides (as ``tests/test_torch_lm_grad.py`` holds zamba2-7b).

It needs jax (the reference); it is not a tier-1 test.
"""
import argparse
import os
import sys
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_l2(a, b):
    a, b = np.float64(np.asarray(a, np.float32)), \
        np.float64(np.asarray(b, np.float32))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", action="append",
                    help="an arch id (repeatable; default all)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--ssd-f32", action="store_true",
                    help="ssd_chunked's explicit bf16 in f32 on both sides")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_arch as ref_arch
    from repro.models import mamba2 as RM2
    from repro.models import modules as RM
    from repro.models import transformer as RT
    from repro.runtime.sharding import ShardingPlan as RPlan
    from repro_torch import convert as CV
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.data.synthetic import DataConfig, batch_for_step
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import modules as M
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import ShardingPlan

    RM.COMPUTE_DTYPE, M.COMPUTE_DTYPE = jnp.dtype("float32"), torch.float32
    if args.ssd_f32:
        class JnpF32(types.ModuleType):
            bfloat16 = jnp.float32

            def __getattr__(self, name):
                return getattr(jnp, name)
        RM2.jnp = JnpF32("jax.numpy")
        M2._bf16 = lambda t: t.float()
    for arch in args.arch or sorted(ARCHS):
        rcfg, cfg = ref_arch(arch).reduced(), get_arch(arch).reduced()
        for seed in args.seeds:
            rp = jax.device_get(RT.init_params(jax.random.key(seed), rcfg))
            text = 32 - (cfg.frontend_len if cfg.frontend == "vision" else 0)
            dc = DataConfig(
                vocab_size=cfg.vocab_size, global_batch=2, seq_len=text,
                seed=seed, frontend=cfg.frontend,
                frontend_len=(cfg.encoder.n_frames if cfg.encoder
                              else cfg.frontend_len),
                frontend_dim=cfg.d_model)
            batch = batch_for_step(dc, 0)
            rb = {k: jnp.asarray(v) for k, v in batch.items()}
            grad = jax.jit(jax.value_and_grad(
                lambda p, b: RT.lm_loss(p, rcfg, b, RPlan(mesh=None))[0]))
            rl, rg = grad(rp, rb)
            ref = dict(CV.tree_items(jax.device_get(rg)))
            signs = np.random.default_rng(seed)
            moved = jax.tree.map(lambda x: (x * (1 + signs.choice(
                [-1, 1], x.shape) * 2.0 ** -23)).astype(x.dtype), rp)
            own = dict(CV.tree_items(jax.device_get(grad(moved, rb)[1])))
            flat = CV.tree_from_reference(rp, "cpu")
            leaves = {k: v.requires_grad_(True) for k, v in flat.items()}
            loss, _ = T.lm_loss(CV.map_tree(lambda k, _v: leaves[k], rp),
                                cfg, {k: torch.from_numpy(v)
                                      for k, v in batch.items()},
                                ShardingPlan(mesh=None))
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
            port = {k: np.zeros(v.shape, np.float32) if g is None
                    else g.numpy() for (k, v), g in zip(leaves.items(), got)}
            worst = max((rel_l2(port[k], ref[k]), k) for k in ref)
            spread = max((rel_l2(own[k], ref[k]), k) for k in ref)
            print(f"{arch} seed {seed}{' ssd-f32' if args.ssd_f32 else ''}: "
                  f"loss rel {abs(float(loss.detach()) / float(rl) - 1):.3g}"
                  f"; port vs reference worst {worst[0]:.4g} ({worst[1]}); "
                  f"reference vs itself one ulp away worst {spread[0]:.4g} "
                  f"({spread[1]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
