"""The PyTorch port stands alone: importing it pulls in no JAX and starts
no process group, no file of it imports the JAX package, entry points refuse to fall back to the CPU
when no GPU is present, and its configs (olmo-1b, xlstm-350m, hymba-1.5b,
qwen2-moe-a2.7b, llama3-8b, gemma2-9b, nemotron-4-15b, qwen3-moe-30b-a3b,
qwen2-vl-72b, whisper-base: all ten) equal the reference's."""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.configs import get_config, get_smoke_config  # noqa: E402

from repro_torch import configs as port_configs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_leaves_jax_out():
    mods = _port_modules()
    for m in ("repro_torch.serving.engine", "repro_torch.launch",
              "repro_torch.launch.cluster_serve", "repro_torch.obs.trace",
              "repro_torch.obs.recorder", "repro_torch.obs.export",
              "repro_torch.distributed.collectives",
              "repro_torch.distributed.sharding",
              "repro_torch.distributed.expert_parallel",
              "repro_torch.launch.mesh", "repro_torch.launch.specs",
              "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
              "repro_torch.launch.report", "repro_torch.models.loops"):
        assert m in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "import torch.distributed as dist\n"
            "if dist.is_available() and dist.is_initialized():\n"
            "    bad.append('a process group')\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_dryrun_modules_import_quietly():
    """The dry-run modules (``launch/{specs,roofline,dryrun,report}``)
    import in a fresh process without setting an environment variable,
    joining a process group or registering the fake backend: the
    reference's dryrun sets XLA_FLAGS at import, the port's run_pair
    joins its fake world when called."""
    mods = [f"repro_torch.launch.{m}" for m in
            ("specs", "roofline", "dryrun", "report")]
    for m in mods:
        assert m in _port_modules(), m
    code = ("import importlib, os, sys\n"
            "env = dict(os.environ)\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import torch.distributed as dist\n"
            "bad = sorted(k for k in set(env) | set(os.environ)\n"
            "             if env.get(k) != os.environ.get(k))\n"
            "if dist.is_initialized():\n"
            "    bad.append('a process group')\n"
            "if 'torch.testing._internal.distributed.fake_pg' in "
            "sys.modules:\n"
            "    bad.append('the fake backend')\n"
            "from repro_torch.models import loops\n"
            "if loops.TRACER is not None:\n"
            "    bad.append('a tracer')\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    for n in names:
        root = n.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, n)


def test_entry_points_default_to_cuda_and_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from repro_torch.models import Model
    from repro_torch.cluster import LiveEdgeNode
    from repro_torch.data.tokenizer import Tokenizer
    from repro_torch.retrieval.encoder import TextEncoder
    from repro_torch.retrieval.index import FlatIndex, build_index
    from repro_torch.retrieval.ivf import IVFIndex
    from repro_torch.serving import ServeEngine
    cfg = port_configs.get_smoke_config("olmo-1b", max_d_model=32, vocab=64)
    params = Model(cfg).init_params(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params, max_len=32, batch_size=1, prefill_chunk=8,
                    paged=True, block_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        FlatIndex(16)
    with pytest.raises(RuntimeError, match="CUDA"):
        IVFIndex(16)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index(16, "ivf")
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveEdgeNode(0, "olmo-1b", cfg, params, [], Tokenizer({}),
                     TextEncoder(dim=16, hash_dim=64), paged=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg).init_params(seed=0)
    from repro_torch.launch.cluster_serve import build_cluster
    with pytest.raises(RuntimeError, match="CUDA"):
        build_cluster(2, paged=True, queue="standing")
    xcfg = port_configs.get_smoke_config("xlstm-350m", max_d_model=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(xcfg).init_params(seed=0)


@pytest.mark.parametrize("arch", ["olmo-1b", "xlstm-350m", "hymba-1.5b",
                                  "qwen2-moe-a2.7b", "llama3-8b",
                                  "gemma2-9b", "nemotron-4-15b",
                                  "qwen3-moe-30b-a3b", "qwen2-vl-72b",
                                  "whisper-base"])
@pytest.mark.parametrize("smoke", [False, True])
def test_olmo_config_matches_reference(smoke, arch):
    if smoke:
        kw = dict(max_d_model=64, vocab=300)
        ours = port_configs.get_smoke_config(arch, **kw)
        theirs = get_smoke_config(arch, **kw)
    else:
        ours = port_configs.get_config(arch)
        theirs = get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert port_configs.ARCH_IDS == ["olmo-1b", "xlstm-350m", "hymba-1.5b",
                                     "qwen2-moe-a2.7b", "llama3-8b",
                                     "gemma2-9b", "nemotron-4-15b",
                                     "qwen3-moe-30b-a3b", "qwen2-vl-72b",
                                     "whisper-base"]
