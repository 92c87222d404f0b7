"""The port stands alone: importing it loads neither JAX nor the
reference package, and no module of it (or chip_smoke.py) imports them."""
import ast
import os
import subprocess
import sys

from conftest import REPO, SRC

PORT = os.path.join(SRC, "repro_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.runtime.fused, repro_torch.runtime.fused_decode, "
            "repro_torch.kernels.megakernel.ops, "
            "repro_torch.kernels.dualquant.ops, "
            "repro_torch.kernels.bitpack.ops, repro_torch.optim, "
            "repro_torch.optim.adamw, repro_torch.optim.grad_compress, "
            "repro_torch.io, repro_torch.io.collectives, "
            "repro_torch.kernels.histogram.ops, "
            "repro_torch.kernels.hufenc.ops, repro_torch.io.engine, "
            "repro_torch.io.filewrite, repro_torch.obs.report, "
            "repro_torch.runtime.sharding, repro_torch.launch.mesh, "
            "repro_torch.checkpoint.ckpt, repro_torch.serve, "
            "repro_torch.serve.paging, repro_torch.models.modules, "
            "repro_torch.models.transformer, repro_torch.configs, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.data.synthetic, repro_torch.runtime.dist, "
            "repro_torch.runtime.pipeline\n"
            # the staged route and compress_batch import lazily: run them
            "import numpy as np\n"
            "from repro_torch.core import CEAZ\n"
            "x = np.linspace(0, 1, 5000, dtype=np.float32)\n"
            "for b in ('torch', 'numpy'):\n"
            "    c = CEAZ(use_fused=False, backend=b, device='cpu')\n"
            "    c.decompress(c.compress(x))\n"
            "CEAZ(device='cpu').compress_batch([x, x])\n"
            # a ceaz stream written, read back and reported on
            "import tempfile, os\n"
            "from repro_torch.io import engine as E, filewrite as FW\n"
            "from repro_torch.obs import report\n"
            "d = tempfile.mkdtemp()\n"
            "FW.parallel_compressed_write(d, [x, x[::-1].copy()], "
            "comp=CEAZ(device='cpu'), fsync=False)\n"
            "back = FW.parallel_read(d, device='cpu')\n"
            "assert len(back) == 2\n"
            "with E.StreamReader(os.path.join(d, FW.DUMP_NAME)) as r:\n"
            "    assert type(r.read_seq(0)).__module__ == "
            "'repro_torch.core.ceaz'\n"
            "assert report.main([os.path.join(d, FW.DUMP_NAME)]) == 0\n"
            # the consumers: a gather stream, a checkpoint and its pager
            "from repro_torch.io import collectives as COL\n"
            "from repro_torch.checkpoint import ckpt as C\n"
            "from repro_torch.serve import PagedParamStore\n"
            "COL.ceaz_gather_stream([x, x], os.path.join(d, 'g.ceazs'), "
            "device='cpu')\n"
            "C.save_checkpoint(os.path.join(d, 'ck'), {'w': x}, 1, "
            "device='cpu')\n"
            "with PagedParamStore(os.path.join(d, 'ck', 'step_00000001', "
            "C.LEAVES_STREAM), device='cpu') as st, st.pin() as p:\n"
            "    assert p.get('w').shape == (5000,)\n"
            # the serving path: a reduced model restored and decoded
            "from repro_torch.configs import get_arch\n"
            "from repro_torch.launch import serve as S\n"
            "from repro_torch.models import transformer as T\n"
            "from repro_torch.runtime.sharding import ShardingPlan\n"
            "import torch\n"
            "cfg = get_arch('gemma3-1b').reduced()\n"
            "C.save_checkpoint(os.path.join(d, 'm'), T.init_params(0, cfg, "
            "device='cpu'), 1, device='cpu')\n"
            "p, _ = S.restore_serving_params(os.path.join(d, 'm'), "
            "ShardingPlan(), device='cpu')\n"
            "dec, tok, cache, _ = S.make_decode_fn(cfg, ShardingPlan(), 2, 8)\n"
            "logits, _ = dec(p, torch.zeros(2, dtype=torch.int32), "
            "T.init_cache(cfg, 2, 8, device='cpu'))\n"
            "assert logits.shape == (2, cfg.vocab_size)\n"
            # MLA and MoE: the reduced deepseek prefilled and decoded
            "cfg = get_arch('deepseek-v2-236b').reduced()\n"
            "p = T.init_params(0, cfg, device='cpu')\n"
            "assert T.serve_prefill(p, cfg, torch.zeros((2, 5), "
            "dtype=torch.int32), ShardingPlan()).shape == (2, cfg.vocab_size)\n"
            "logits, _ = T.serve_decode(p, cfg, torch.zeros(2, dtype=torch.int32), "
            "T.init_cache(cfg, 2, 8, device='cpu'), ShardingPlan())\n"
            # the SSM archs: zamba2 (mamba2, the shared block), rwkv6
            "for a in ('zamba2-7b', 'rwkv6-1.6b'):\n"
            "    cfg = get_arch(a).reduced()\n"
            "    p = T.init_params(0, cfg, device='cpu')\n"
            "    assert T.serve_prefill(p, cfg, torch.zeros((2, 16), "
            "dtype=torch.int32), ShardingPlan()).shape == (2, cfg.vocab_size)\n"
            "    logits, _ = T.serve_decode(p, cfg, torch.zeros(2, "
            "dtype=torch.int32), T.init_cache(cfg, 2, 8, device='cpu'), "
            "ShardingPlan())\n"
            # training: a reduced step, checkpointed
            "from repro_torch.launch import train as TR\n"
            "TR.main(['--arch', 'gemma3-1b', '--reduced', '--steps', '1', "
            "'--batch', '2', '--seq', '16', '--device', 'cpu', "
            "'--ckpt-dir', os.path.join(d, 't')])\n"
            "from repro_torch.core import compress, decompress, dequantize\n"
            "assert decompress(compress(x, device='cpu'), device='cpu').shape "
            "== x.shape\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_core_exports_the_reference_names():
    """Every name of ``repro.core.__all__`` is exported by the port's
    core, constants with the reference's values."""
    import repro.core as R
    import repro_torch.core as P
    assert set(R.__all__) <= set(P.__all__)
    assert set(P.__all__) - set(R.__all__) == {"CompressedChunk"}
    for name in R.__all__:
        got, ref = getattr(P, name), getattr(R, name)
        if isinstance(ref, (int, float)):
            assert got == ref, name
        else:
            assert callable(got) == callable(ref), name


def test_no_source_imports_jax_or_reference():
    files = _port_files()
    assert len(files) > 20
    for new in ("kernels/histogram/ops.py", "kernels/hufenc/ops.py",
                "core/ceaz.py", "runtime/fused.py", "io/engine.py",
                "io/filewrite.py", "obs/manifest.py", "obs/report.py",
                "runtime/sharding.py", "launch/mesh.py",
                "checkpoint/ckpt.py", "serve/paging.py",
                "models/modules.py", "models/transformer.py",
                "configs/__init__.py", "configs/base.py",
                "configs/gemma3_1b.py", "configs/gemma3_4b.py",
                "configs/gemma_7b.py", "configs/glm4_9b.py",
                "configs/qwen2_vl_7b.py", "configs/whisper_base.py",
                "configs/deepseek_v2_236b.py", "configs/phi35_moe_42b.py",
                "launch/serve.py", "launch/train.py", "data/synthetic.py",
                "runtime/dist.py", "runtime/pipeline.py"):
        assert os.path.join(PORT, new) in files, new
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path, name)
