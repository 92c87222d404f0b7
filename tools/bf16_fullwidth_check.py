#!/usr/bin/env python3
"""Is the bf16 excess over the models' bound the reference's own? Runs on
the CPU, through the JAX reference and the port, with the same
parameters and tokens.

    PYTHONPATH=src python3 tools/bf16_fullwidth_check.py [--prompt 64]
    PYTHONPATH=src python3 tools/bf16_fullwidth_check.py --arch zamba2-7b
    PYTHONPATH=src python3 tools/bf16_fullwidth_check.py --arch rwkv6-1.6b --reduced
    PYTHONPATH=src python3 tools/bf16_fullwidth_check.py --moe-decode

Default: an arch (--arch, gemma3-1b unless named) at its published
widths cut to its first unit's first repeat (gemma3-1b: 5 local layers
with a 512 window and 1 global, d_model 1152, vocab 262144; zamba2-7b:
the shared attention block and 6 mamba2 layers, d_model 3584, vocab
32000; rwkv6-1.6b: one layer, d_model 2048, vocab 65536), parameters
drawn by the port's init from --seed and carried to the reference as
numpy arrays, a seeded prompt of B x --prompt tokens (a multiple of 16
for rwkv6). With ``--reduced`` the arch's reduced config instead, with
the reference's parameters at the key the parity tests give it
(``tests/test_torch_models.py::KEYS``). For each package it prints its
bf16 prefill logits against its own teacher-forced decode at the
prompt's last token, as a ratio to the bound (rtol 0.06, atol 0.05; 1.0
is the bound), the reference's prefill run op by op (``jax.disable_jit``)
against its compiled one, and the two packages' prefills and last steps
against each other. With ``--layers`` it also prints, for each layer,
the largest difference between the packages' bf16 prefill hidden states
(the first layer where they part).

``--moe-decode``: the reduced deepseek-v2 and phi3.5-moe (the parity
tests' sizes and seeds) decoding 24 greedy bf16 steps: the reference's
jitted step against its own eager step, and the port against the jitted
one, each step as a ratio to the bound.

It needs jax (the reference) and up to about 16 GB of memory at the
default sizes (zamba2's cut: 788 M parameters in both packages); it is
not a tier-1 test.
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 0.06, 0.05


def ratio(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(g - w) / (ATOL + RTOL * np.abs(w))).max())


def _f32(x):
    import torch
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _keys(archs):
    """The parity tests' reference key of each arch
    (tests/test_torch_models.py::KEYS)."""
    ssm = ("rwkv6-1.6b", "zamba2-7b")
    order = [a for a in sorted(archs) if a not in ssm] + list(ssm)
    return {a: 10 + i for i, a in enumerate(order)}


def fullwidth(args):
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_arch as ref_arch
    from repro.models import modules as RM
    from repro.models import transformer as RT
    from repro.runtime.sharding import ShardingPlan as RPlan
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.convert import map_tree, tree_from_reference
    from repro_torch.models import modules as M
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import ShardingPlan
    cut = lambda cfg: dataclasses.replace(cfg, units=(dataclasses.replace(
        cfg.units[0], repeat=1),))
    plan, rplan = ShardingPlan(mesh=None), RPlan(mesh=None)
    if args.reduced:
        cfg, rcfg = get_arch(args.arch).reduced(), ref_arch(args.arch).reduced()
        key = _keys(ARCHS)[args.arch]
        rparams = jax.device_get(RT.init_params(jax.random.key(key), rcfg))
        flat = tree_from_reference(rparams, "cpu")
        params = map_tree(lambda k, _v: flat[k], rparams)
        what = f"reduced, key {key}"
    else:
        cfg, rcfg = cut(get_arch(args.arch).config()), \
            cut(ref_arch(args.arch).config())
        params = T.init_params(args.seed, cfg, device="cpu")
        rparams = map_tree(lambda _k, v: jnp.asarray(v.numpy()), params)
        what = "cut to its first repeat at full width"
    n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(rparams))
    B, S = args.batch, args.prompt
    prompt = np.random.default_rng(args.seed + 7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None
    print(f"{args.arch} {what}, {cfg.n_layers} layers, {n} parameters; "
          f"prompt {B} x {S}; bf16")
    t0 = time.perf_counter()
    rpre = np.asarray(RT.serve_prefill(rparams, rcfg, jnp.asarray(prompt),
                                       rplan), np.float32)
    rstep = jax.jit(lambda p, t, c: RT.serve_decode(p, rcfg, t, c, rplan))
    rc = RT.init_cache(rcfg, B, 1024)
    for t in range(S):
        rlog, rc = rstep(rparams, jnp.asarray(prompt[:, t]), rc)
    rlog = np.asarray(rlog, np.float32)
    with jax.disable_jit():
        reager = np.asarray(RT.serve_prefill(rparams, rcfg,
                                             jnp.asarray(prompt), rplan),
                            np.float32)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptok = torch.from_numpy(prompt)
    ppre = _f32(T.serve_prefill(params, cfg, ptok, plan))
    cache = T.init_cache(cfg, B, 1024, device="cpu")
    for t in range(S):
        plog, cache = T.serve_decode(params, cfg, ptok[:, t], cache, plan)
    plog = _f32(plog)
    port_s = time.perf_counter() - t0
    print(f"reference: prefill vs its teacher-forced step {S}: "
          f"{ratio(rlog, rpre)}; its prefill op by op vs compiled: "
          f"{ratio(reager, rpre)} ({ref_s:.1f} s)")
    print(f"port:      prefill vs its teacher-forced step {S}: "
          f"{ratio(plog, ppre)} ({port_s:.1f} s)")
    print(f"port vs reference: prefill {ratio(ppre, rpre)} (vs op by op "
          f"{ratio(ppre, reager)}), step {S} {ratio(plog, rlog)}")
    if args.layers:
        h = M.embed_apply(params, ptok, plan, scale=scale)
        rh = RM.embed_apply(rparams, jnp.asarray(prompt), rplan, scale=scale)
        pos, rpos = torch.arange(S)[None, :], jnp.arange(S)[None, :]
        aux, raux = torch.zeros(()), jnp.float32(0)
        for i, b in enumerate(cfg.units[0].blocks):
            bp = params["shared"] if b.use_shared else \
                T._index(params["units"][0], 0)[f"b{i}"]
            rbp = rparams["shared"] if b.use_shared else jax.tree.map(
                lambda x: x[0], rparams["units"][0])[f"b{i}"]
            h, aux = T._block_apply(bp, b, h, pos, plan, aux, None)
            rh, raux = RT._block_apply(rbp, rcfg.units[0].blocks[i], rh,
                                       rpos, rplan, raux, None)
            kind = b.kind if b.kind != "attn" else (
                "local" if b.attn.window else "global")
            print(f"layer {i} ({kind}): largest |port - reference| of the "
                  f"hidden state {float(np.abs(_f32(h) - _f32(rh)).max())}")


def moe_decode(args):
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_arch as ref_arch
    from repro.models import modules as RM
    from repro.models import transformer as RT
    from repro.runtime.sharding import ShardingPlan as RPlan
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.convert import map_tree, tree_from_reference
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import ShardingPlan
    plan, rplan = ShardingPlan(mesh=None), RPlan(mesh=None)
    torch.set_num_threads(1)

    def eager_step(rp, rcfg, token, cache):
        """The reference's serve_decode with its layer scan unrolled, op
        by op (no jit)."""
        pos = cache["pos"]
        h = RM.embed_apply(rp, token[:, None], rplan)
        units = []
        for ui, unit in enumerate(rcfg.units):
            per = []
            for r in range(unit.repeat):
                ps = jax.tree.map(lambda x: x[r], rp["units"][ui])
                cs = jax.tree.map(lambda x: x[r], cache["units"][ui])
                nc = {}
                for bi, b in enumerate(unit.blocks):
                    h, nc[f"b{bi}"] = RT._block_decode(
                        ps[f"b{bi}"], b, h, pos, cs[f"b{bi}"], rplan)
                per.append(nc)
            units.append(jax.tree.map(lambda *x: jnp.stack(x), *per))
        h = RM.norm_apply(rp["final_norm"], h)
        return RM.unembed_logits(rp, h, rplan)[:, 0], \
            {**cache, "units": units, "pos": pos + 1}

    for arch in ("deepseek-v2-236b", "phi3.5-moe-42b-a6.6b"):
        rcfg, cfg = ref_arch(arch).reduced(), get_arch(arch).reduced()
        key = 10 + sorted(ARCHS).index(arch)
        rp = jax.device_get(RT.init_params(jax.random.key(key), rcfg))
        flat = tree_from_reference(rp, "cpu")
        params = map_tree(lambda k, _v: flat[k], rp)
        jit_step = jax.jit(lambda p, t, c: RT.serve_decode(p, rcfg, t, c,
                                                           rplan))
        rc = rc2 = RT.init_cache(rcfg, 2, 32)
        cache = T.init_cache(cfg, 2, 32, device="cpu")
        tok = np.random.default_rng(123).integers(
            0, cfg.vocab_size, (2,)).astype(np.int32)
        eager, port = [], []
        for _ in range(24):
            rj, rc = jit_step(rp, jnp.asarray(tok), rc)
            re, rc2 = eager_step(rp, rcfg, jnp.asarray(tok), rc2)
            pl, cache = T.serve_decode(params, cfg, torch.from_numpy(tok),
                                       cache, plan)
            eager.append(round(ratio(re, rj), 3))
            port.append(round(ratio(_f32(pl), rj), 3))
            tok = np.asarray(jnp.argmax(rj, -1), np.int32)
        print(f"{arch} (reduced, key {key}), 24 greedy bf16 steps, ratio "
              f"to the bound a step:\n  reference eager vs jitted: "
              f"{eager}\n  port vs reference jitted:   {port}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="gemma3-1b",
                    choices=("gemma3-1b", "zamba2-7b", "rwkv6-1.6b"))
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (the parity tests' "
                         "parameters) instead of its full-width cut")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--layers", action="store_true",
                    help="also compare the packages' hidden states layer "
                         "by layer")
    ap.add_argument("--moe-decode", action="store_true",
                    help="the reduced MoE archs' bf16 decode instead")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if args.moe_decode:
        moe_decode(args)
    else:
        fullwidth(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
