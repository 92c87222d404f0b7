#!/usr/bin/env python3
"""The MoE's expert-parallel gradients on the CPU: the reference's
``moe_apply`` on a (data=1, model=2) mesh of host devices against its own
one-device ``moe_apply``, and the port's ranks (a gloo world of 2) against
the reference's expert-parallel gradients, on the cases of
``tests/test_torch_moe_ep.py`` (reduced phi3.5-moe and deepseek-v2, f32
and bf16, an overfull router).

    PYTHONPATH=src python3 tools/moe_ep_grads.py

Prints, per case, the worst leaf's relative L2 of each comparison (the
loss is sum(y c) + aux) and whether the reference's expert-parallel
gradients are scaled by the model axis's size against its one-device
ones (the ratio of their norms).
"""
import os
import pickle
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), os.path.join(ROOT, "src")]

_ONE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_arch
from repro.models import modules as RM
from repro.runtime.sharding import ShardingPlan
cases = pickle.load(open(IN_PATH, 'rb'))
out = {}
for key, (arch, dt, p, x, c) in cases.items():
    cfg = next(b.moe for u in get_arch(arch).reduced().units
               for b in u.blocks if b.mlp_kind == 'moe')
    dtype = jnp.float32 if dt == 'f32' else jnp.bfloat16
    def loss(p, xj):
        y, aux = RM.moe_apply(p, cfg, xj, ShardingPlan(mesh=None))
        return jnp.sum(y.astype(jnp.float32) * c) + aux
    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x, dtype))
    flat = {'x': np.asarray(g[1], np.float32)}
    for path, v in jax.tree_util.tree_flatten_with_path(g[0])[0]:
        flat['/'.join(k.key for k in path)] = np.asarray(v)
    out[key] = flat
pickle.dump(out, open(OUT_PATH, 'wb'))
"""


def main():
    import numpy as np
    import test_torch_moe_ep as T
    from conftest import run_with_devices
    d = tempfile.mkdtemp()
    src = os.path.join(d, "in.pkl")
    with open(src, "wb") as f:
        pickle.dump({k: (k[0], k[1], *T._inputs(*k)) for k in T.CASES}, f)
    got = {}
    for name, code, n in (("ep", T._REF, 2), ("one", _ONE, 1)):
        dst = os.path.join(d, f"{name}.pkl")
        run_with_devices(code.replace("IN_PATH", repr(src))
                         .replace("OUT_PATH", repr(dst)), n_devices=n)
        with open(dst, "rb") as f:
            got[name] = pickle.load(f)
    ranks = [r.result for r in T.D.launch(T.ep_ranks, 2, timeout=300,
                                          threads=1)]
    for key in T.CASES:
        ep, one = got["ep"][key]["grads"], got["one"][key]
        ref_vs_one = max((T._rel_l2(ep[k], one[k]), k) for k in one)
        ratio = float(np.sqrt(sum(np.sum(np.square(ep[k], dtype=np.float64))
                                  for k in one)
                              / sum(np.sum(np.square(one[k],
                                                     dtype=np.float64))
                                    for k in one)))
        port = ranks[0][key]["grads"]
        port_vs_ep = max((T._rel_l2(port[k].float().numpy(), ep[k]), k)
                         for k in ep)
        print(f"{'-'.join(key)}: reference EP vs one device, worst leaf "
              f"{ref_vs_one}, norm ratio {ratio}; port EP vs reference EP, "
              f"worst leaf {port_vs_ep}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
