"""The port's dry-run tooling (``repro_torch.launch.{specs, roofline,
dryrun, report}``) against the reference's on the CPU:

  (i)   ``input_specs`` equals the reference's ShapeDtypeStructs, key for
        key, for all 10 archs x 4 input shapes;
  (ii)  ``build_step``'s ``meta`` equals the reference's for 10 x 4 on the
        16x16, 2x16x16 and 4x4 meshes (the reference's side is one child
        process with 512 placeholder devices that calls its
        ``build_step`` without compiling), and the port's own decode
        cache holds the reference layout's bytes but for its ``length``,
        a host int here;
  (iii) ``model_flops`` and ``analytic_memory_bytes`` equal the
        reference's on each pair's ``meta``;
  (iv)  a 6-trip loop of [8,32] @ [32,32] counts 2*8*32*32*6 = 98,304
        flops, as the reference's ``analyze`` of its compiled scan;
  (v)   at olmo-1b's smoke config on a 1x1 mesh the traced flops of
        train, prefill and decode equal the reference's compiled ones up
        to two named gaps, each exact: the reference's blocked attention
        computes whole [S, S] blocks where the flash kernel counts causal
        pairs, and XLA merges the fused cross-entropy's forward logits
        with the backward's recomputation, which eager PyTorch runs twice;
  (vi)  the olmo-1b decode_32k pair on a 4x4 fake world, in a child
        process, as the reference's ``test_dryrun_pair_on_16_devices``:
        OK, flops > 0, argument + temp bytes < 200e9;
  (vii) the token loops' three-trip weighting and the MoE's fake-tensor
        width are exact against full traces at short sequences.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import InputShape as JInputShape  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import tensor_parallel as tpl  # noqa: E402
from repro_torch.launch import dryrun, report, roofline, specs  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.train.train_step import (init_opt_state,  # noqa: E402
                                          make_train_step)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = configs.ARCH_IDS
SHAPES = list(configs.INPUT_SHAPES)
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "4x4": (("data", "model"), (4, 4))}
M11 = MeshShape(("data", "model"), (1, 1))
_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32,
       "int32": torch.int32}

_REF_META = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro.launch.mesh import make_mesh
from repro.launch.specs import build_step
MESHES = %s
out = {}
for name, (axes, shape) in MESHES.items():
    mesh = make_mesh(tuple(shape), tuple(axes))
    for arch in ARCH_IDS:
        for s in INPUT_SHAPES:
            out["|".join((arch, s, name))] = build_step(
                get_config(arch), INPUT_SHAPES[s], mesh)[4]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_meta():
    """The reference's ``meta`` for every (arch, shape, mesh)."""
    out = subprocess.run(
        [sys.executable, "-c", _REF_META % json.dumps(MESHES)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------------- (i)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    cfg, jcfg = configs.get_config(arch), j_get_config(arch)
    for name in SHAPES:
        ref = jspecs.input_specs(jcfg, J_SHAPES[name])
        ours = specs.input_specs(cfg, configs.INPUT_SHAPES[name])
        assert list(ours) == list(ref), (arch, name)
        for k, s in ref.items():
            assert tuple(ours[k].shape) == tuple(s.shape), (arch, name, k)
            assert ours[k].dtype == _DT[str(s.dtype)], (arch, name, k)
            assert ours[k].device.type == "meta"
        rows = specs.input_specs(cfg, configs.INPUT_SHAPES[name], rows=3)
        assert all(t.shape[1 if k == "positions" and t.dim() == 3 else 0]
                   == 3 for k, t in rows.items())


# ------------------------------------------------------------------ (ii)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_build_step_meta_matches_reference(arch, mesh, ref_meta):
    """``meta`` key for key on every shape; the spec trees name the
    mesh's axes only; the args hold the rank's rows."""
    axes, shape = MESHES[mesh]
    m = MeshShape(axes, shape)
    cfg = configs.get_config(arch)
    for name in SHAPES:
        s = configs.INPUT_SHAPES[name]
        step, args, in_specs, out_specs, meta = specs.build_step(cfg, s, m)
        assert meta == ref_meta["|".join((arch, name, mesh))], (arch, name)
        if s.mode == "train":
            assert args[2]["tokens"].shape[0] == s.global_batch
            assert set(in_specs[1]) == {"step", "mu", "nu"}
        else:
            rows = args[1].shape[0] if s.mode == "decode" \
                else args[1]["tokens"].shape[0]
            assert rows == meta["batch_per_dev"]
            cache = args[2]
            # the sharded program's cache holds this rank's slots
            lay = cache.layout
            assert lay is None or lay.attn.full == s.seq_len
            assert cache.k.shape[1:3] == (
                rows, s.seq_len if lay is None else lay.attn.local)
            assert cache.length == (s.seq_len - 1 if s.mode == "decode"
                                    else 0)
        for spec in specs.sh.leaves(in_specs[0]):
            assert all(a in axes for e in spec
                       for a in ((e,) if isinstance(e, str) else e or ()))


SHARDED = [a for a in ARCHS if tpl.supported(configs.get_config(a))]
DENSE = ("olmo-1b", "llama3-8b", "gemma2-9b", "nemotron-4-15b",
         "qwen2-vl-72b")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SHARDED)
def test_sharded_program_holds_the_reference_bytes(arch, mesh):
    """Every arch runs the sharded program: on every mesh and shape the
    rank's params (and AdamW moments, f32) hold
    ``meta["param_bytes_per_dev"]``, and its prefill and decode cache the
    reference layout's bytes under ``cache_specs``: K/V buffers, the
    recurrent state (whole on every rank) and whisper's cross-attention
    K/V (``meta`` adds the reference's ``length`` scalar and replicated
    ``first`` [B])."""
    from repro_torch.distributed import sharding as sh
    axes, shape = MESHES[mesh]
    m = MeshShape(axes, shape)
    cfg = configs.get_config(arch)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    for name in SHAPES:
        s = configs.INPUT_SHAPES[name]
        if not configs.shape_applicable(cfg, s):
            continue
        _, args, _, _, meta = specs.build_step(cfg, s, m)
        assert nbytes(sh.leaves(args[0])) == meta["param_bytes_per_dev"], \
            (name, nbytes(sh.leaves(args[0])), meta["param_bytes_per_dev"])
        if s.mode == "train":
            # f32 moments: twice the bf16 params' bytes (hymba's f32
            # A_log and D once)
            assert nbytes(sh.leaves(args[1].mu)) == \
                4 * sum(t.numel() for t in sh.leaves(args[0]))
            continue
        cache = args[2]
        ours = nbytes([cache.k, cache.v] + [
            t for st in cache.state.values() for t in st.values()])
        ref = specs.reference_cache(cfg, s.global_batch, s.seq_len)
        cspec = sh.cache_specs(cfg, ref, m,
                               shard_seq=(name == "long_500k"))
        kv = sum(sh.local_bytes(ref[k], cspec[k], m)
                 for k in ("slots", "enc") if k in ref)
        assert ours == kv, (name, ours, kv)
        assert meta["cache_bytes_per_dev"] == kv + 4 + 4 * s.global_batch
        # a dense decoder's K/V: at most 1/model of the whole cache a
        # rank (recurrent state, hymba's 5 KV heads and whisper's 8 stay
        # whole on 16 ranks by the reference's rules)
        if arch in DENSE:
            assert ours * shape[-1] <= nbytes(sh.leaves(ref["slots"]))


_COLLECTIVES_4X4 = r"""
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
from repro_torch.distributed import _compat
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((4, 4), ("data", "model"), device_type="cpu")


def fsdp(x):
    g = _compat.all_gather(x, mesh, "data", 0)
    return _compat.reduce_scatter(g, mesh, "data", 0)


out = roofline.analyze(fsdp, torch.ones(8, 4)).per_collective
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_fake_world_counts_fsdp_collectives():
    """The FSDP pair on the fake backend: the all-gather's operand (one
    [8, 4] f32 shard) and the reduce-scatter's (the gathered [32, 4]),
    under the reference's names."""
    out = subprocess.run([sys.executable, "-c", _COLLECTIVES_4X4],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=dict(os.environ,
                                            PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    coll = json.loads(out.stdout.strip().splitlines()[-1])
    assert coll == {"all-gather": 128.0, "reduce-scatter": 512.0}


@pytest.mark.parametrize("arch", ARCHS)
def test_port_cache_holds_the_reference_layout(arch):
    """The port's decode cache holds the reference layout's bytes, but
    for the reference's ``length`` (an int32 scalar there, a host int
    here): ``meta["cache_bytes_per_dev"]`` counts the reference's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get_config(arch)
    with FakeTensorMode():
        cache = Model(cfg).init_cache(4, 512, device="cpu")
    leaves = [cache.k, cache.v, cache.first] + [
        t for st in cache.state.values() for t in st.values()]
    ours = sum(t.numel() * t.element_size() for t in leaves)
    ref = specs.reference_cache(cfg, 4, 512)
    theirs = sum(t.numel() * t.element_size()
                 for t in specs.sh.leaves(ref))
    assert isinstance(cache.length, int)
    assert theirs - ours == ref["length"].element_size() == 4


# ----------------------------------------------------------------- (iii)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_analytic_bytes_match_reference(arch, ref_meta):
    cfg, jcfg = configs.get_config(arch), j_get_config(arch)
    for name in SHAPES:
        s, js = configs.INPUT_SHAPES[name], J_SHAPES[name]
        assert roofline.model_flops(cfg, s) == jroof.model_flops(jcfg, js)
        for mesh in MESHES:
            meta = ref_meta["|".join((arch, name, mesh))]
            assert roofline.analytic_memory_bytes(cfg, s, meta) == \
                jroof.analytic_memory_bytes(jcfg, js, meta), (name, mesh)


def test_roofline_terms_and_constants():
    """The reference's arithmetic with the card's constants."""
    st = roofline.TraceStats(dot_flops=3e12, hbm_bytes=2e9,
                             collective_bytes=5e8)
    t = roofline.roofline_terms(st, model_flops_global=1e14, chips=16,
                                analytic_bytes=1e9)
    j = jroof.roofline_terms(jroof.HLOStats(dot_flops=3e12, hbm_bytes=2e9,
                                            collective_bytes=5e8),
                             model_flops_global=1e14, chips=16,
                             analytic_bytes=1e9)
    assert set(t) == set(j)
    assert t["compute_s"] == 3e12 / 989e12
    assert t["memory_s"] == 1e9 / 3.35e12
    assert t["memory_hlo_upper_s"] == 2e9 / 3.35e12
    assert t["collective_s"] == 5e8 / 50e9
    assert t["dominant"] == "collective"
    for k in ("model_flops", "hlo_flops_global", "useful_flops_ratio"):
        assert t[k] == j[k]
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NET_BW) == \
        (989e12, 3.35e12, 50e9)
    assert roofline.type_bytes(torch.float32, (8, 64)) == \
        jroof.type_bytes("f32[8,64]{1,0}") == 8 * 64 * 4
    assert roofline.type_bytes(torch.bfloat16, (2, 3)) == 12
    assert roofline.type_bytes(torch.bool, (7,)) == 7


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (True, 40), (False, None)])
@pytest.mark.parametrize("Sq,Sk", [(1, 1), (1, 33), (7, 7), (16, 16),
                                   (5, 30)])
def test_flash_pairs_counts_right_aligned_pairs(Sq, Sk, causal, window):
    qp = torch.arange(Sq) + (Sk - Sq)
    kp = torch.arange(Sk)
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= kp[None] <= qp[:, None]
        if window:
            ok &= qp[:, None] - kp[None] < window
    assert roofline.flash_pairs(3, Sq, Sk, causal, window) == \
        3 * int(ok.sum())


# ------------------------------------------------------------------ (iv)


def test_six_trip_loop_counts_like_the_reference_scan():
    from repro_torch.models import loops

    def f(w, x):
        outs = []
        for t in loops.trips(w.shape[0], "scan"):
            x = torch.tanh(x @ w[t])
            outs.append(x)
        return torch.stack(loops.full(outs, w.shape[0])).sum()

    want = 2 * 8 * 32 * 32 * 6
    st = roofline.analyze(f, torch.zeros(6, 32, 32), torch.zeros(8, 32))
    assert st.dot_flops == want == 98_304
    assert st.loop_trips == {"scan": 6}
    assert st.op_counts["aten.mm.default"] == 6
    full = roofline.analyze(f, torch.zeros(6, 32, 32), torch.zeros(8, 32),
                            every_trip=True)
    assert (full.dot_flops, full.hbm_bytes, full.op_counts) == \
        (st.dot_flops, st.hbm_bytes, st.op_counts)

    def jf(w, x):
        def body(x, wi):
            return jnp.tanh(x @ wi), ()
        x, _ = jax.lax.scan(body, x, w)
        return x.sum()

    txt = jax.jit(jf).lower(jnp.zeros((6, 32, 32)),
                            jnp.zeros((8, 32))).compile().as_text()
    assert jroof.analyze(txt).dot_flops == st.dot_flops


# ------------------------------------------------------------------- (v)


SMOKE_S, SMOKE_B = 64, 2


def test_smoke_flops_match_reference_up_to_named_gaps():
    from repro.launch.mesh import make_host_mesh
    jcfg = j_smoke("olmo-1b")
    cfg = configs.get_smoke_config("olmo-1b")
    jmesh = make_host_mesh(1, 1)
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    B, S = SMOKE_B, SMOKE_S
    # (query, key) pairs: whole [S, S] blocks there, causal pairs here
    attn_pairs_gap = B * S * S - roofline.flash_pairs(B, S, S)
    ce_rows = B * -(-S // 256) * 256        # the fused CE's padded chunks
    for mode, attn_flops_per_pair in (("train", 4 + 4 + 10),
                                      ("prefill", 4), ("decode", 0)):
        shape = configs.InputShape("smoke", S, B, mode)
        step, args, ins, outs, _ = jspecs.build_step(
            jcfg, JInputShape("smoke", S, B, mode), jmesh)
        with jmesh:
            txt = jax.jit(step, in_shardings=ins, out_shardings=outs).lower(
                *args).compile().as_text()
        ref = jroof.analyze(txt).dot_flops
        pstep, pargs, *_ = specs.build_step(cfg, shape, M11)
        st = roofline.analyze(pstep, *pargs)
        gap = -attn_flops_per_pair * hd * H * L * attn_pairs_gap
        if mode == "train":
            gap += 2 * ce_rows * cfg.d_model * cfg.vocab_size
        assert st.dot_flops - ref == gap, (mode, st.dot_flops, ref)
        if mode == "prefill":                  # within 2% without the CE
            assert abs(st.dot_flops - ref) <= 0.02 * ref
        kernel = st.op_flops.get("kernel.flash_attention", 0) \
            + st.op_flops.get("kernel.flash_attention_bwd", 0)
        if mode != "decode":
            assert kernel == attn_flops_per_pair * hd * H * L \
                * roofline.flash_pairs(B, S, S)


def _wrapper_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    flash = ((r(2, 12, 4, 16), r(2, 12, 2, 16), r(2, 12, 2, 16), pos,
              pos.contiguous()), {"window": 5},
             4 * 4 * 16 * roofline.flash_pairs(2, 12, 12, True, 5))
    tables = torch.tensor([[0, 2], [1, -1]], dtype=torch.int32)
    paged = ((r(2, 4, 16), r(3, 8, 2, 16), r(3, 8, 2, 16), tables,
              torch.tensor([0, 2], dtype=torch.int32),
              torch.tensor([13, 6], dtype=torch.int32)), {},
             4 * 4 * 16 * 2 * 2 * 8)
    topk = ((r(3, 16), r(40, 16), 5), {}, 2 * 3 * 40 * 16)
    probe = torch.tensor([[0, 1], [2, 0]], dtype=torch.int32)
    ivf = ((r(2, 16), r(3, 6, 16), torch.arange(18, dtype=torch.int32)
            .reshape(3, 6), probe, 4), {}, 2 * 16 * 4 * 6)
    return {"flash_attention": flash, "paged_decode_attention": paged,
            "retrieval_topk": topk, "ivf_retrieval_topk": ivf}


@pytest.mark.parametrize("name", ["flash_attention",
                                  "paged_decode_attention",
                                  "retrieval_topk", "ivf_retrieval_topk"])
def test_kernel_wrappers_count_as_one_op(name):
    """Each ``ops`` wrapper is one op of its formula's flops while a
    trace runs (its plain version's ops uncounted, its result the plain
    version's), and is put back afterwards; flash's gradient is one
    ``flash_attention_bwd``."""
    from repro_torch.kernels import ops
    args, kw, flops = _wrapper_cases()[name]
    wrapper = getattr(ops, name)
    st = roofline.analyze(lambda *a: getattr(ops, name)(*a, **kw), *args)
    assert getattr(ops, name) is wrapper
    assert st.op_counts == {f"kernel.{name}": 1.0}
    assert st.dot_flops == flops
    want = wrapper(*args, **kw)
    got = {}
    roofline.analyze(lambda *a: got.setdefault(
        "out", getattr(ops, name)(*a, **kw)), *args)
    for a, b in zip(torch.utils._pytree.tree_leaves(got["out"]),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    if name == "flash_attention":
        def grad(q, k, v, qp, kp):
            q, k, v = (t.requires_grad_(True) for t in (q, k, v))
            out = ops.flash_attention(q, k, v, qp, kp, **kw)
            return torch.autograd.grad(out.sum(), (q, k, v))
        st = roofline.analyze(grad, *args)
        assert st.op_counts["kernel.flash_attention"] == 1
        assert st.op_counts["kernel.flash_attention_bwd"] == 1
        assert st.op_flops["kernel.flash_attention_bwd"] == flops * 10 // 4


# ------------------------------------------------------------------ (vi)

_PAIR_4X4 = r"""
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((4, 4), ("data", "model"), device_type="cpu")
rec = dict(status="OK", **dryrun.trace_pair(
    get_config("olmo-1b"), INPUT_SHAPES["decode_32k"], mesh, 16))
import torch
from repro_torch.launch import roofline


def collectives(x):
    dist.all_reduce(x, group=mesh.get_group("data"))
    parts = [torch.empty_like(x) for _ in range(4)]
    dist.all_gather(parts, x, group=mesh.get_group("model"))
    return torch.cat(parts)


rec["coll"] = roofline.analyze(collectives, torch.ones(8, 4)).per_collective
dist.destroy_process_group()
print(json.dumps(rec))
"""


def test_dryrun_pair_on_a_16_rank_fake_world():
    out = subprocess.run([sys.executable, "-c", _PAIR_4X4],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=dict(os.environ,
                                            PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "OK"
    assert rec["hlo"]["dot_flops_per_dev"] > 0
    mem = rec["memory"]
    assert mem["argument_bytes"] + mem["temp_bytes"] < 200e9
    # 4 data ranks: 32 of the 128 rows, the whole 32k context each
    assert rec["meta"]["batch_per_dev"] == 32
    assert rec["hlo"]["op_counts"]["kernel.flash_attention"] == 16
    assert rec["roofline"]["dominant"] == "memory"
    # each c10d op's operand bytes, under the reference's names
    assert rec["coll"] == {"all-reduce": 128.0, "all-gather": 128.0}


def test_dryrun_skip_record_and_report(tmp_path, capsys):
    """A pair the long-context policy skips: a SKIP record with the
    reference's reason, no world joined; ``report`` tabulates records in
    the reference's columns."""
    import torch.distributed as dist
    rec = dryrun.run_pair("olmo-1b", "long_500k", False, str(tmp_path))
    assert rec["status"] == "SKIP" and "sub-quadratic" in rec["reason"]
    assert not dist.is_initialized()
    ok = {"arch": "olmo-1b", "shape": "train_4k", "mesh": "16x16",
          "status": "OK", "memory": {"per_device_total": 3 * 2 ** 30},
          "roofline": {"compute_s": 0.5, "memory_s": 0.25,
                       "collective_s": 0.125, "dominant": "compute",
                       "useful_flops_ratio": 0.04}}
    (tmp_path / "ok.json").write_text(json.dumps(ok))
    recs = report.load(str(tmp_path))
    assert len(recs) == 2
    report.main(["--dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "### Mesh 16x16" in text
    assert ("| olmo-1b | train_4k | OK | 3.00 | 500.00 | 250.00 | 125.00 "
            "| compute | 0.04 |") in text
    assert "| olmo-1b | long_500k | SKIP (long_500k needs sub-quadratic" \
        in text
    lines = text.splitlines()
    assert lines[lines.index("### Mesh 16x16") + 2] == (
        "| arch | shape | status | mem/dev GiB | compute ms | memory ms | "
        "collective ms | dominant | useful FLOPs |")


# ----------------------------------------------------------------- (vii)


@pytest.mark.parametrize("arch,S", [("hymba-1.5b", 520),
                                    ("xlstm-350m", 520)])
def test_loop_weighting_equals_every_trip(arch, S):
    """Prefill and a remat train step of the smoke model, three trips a
    loop against every trip: the same flops, bytes and op counts (the
    Mamba blocks and steps nest; the mLSTM chunks and sLSTM tokens run
    side by side)."""
    cfg = configs.get_smoke_config(arch)
    model = Model(cfg)
    params = model.init_params(seed=0, device="cpu", max_seq=S)
    g = torch.Generator().manual_seed(0)
    B = 2
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                        dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S).contiguous()

    def prefill(params, tok, pos):
        return model.prefill(params, tok, pos,
                             model.init_cache(B, S, device="cpu"))

    cases = [(prefill, (params, tok, pos))]
    St = 300
    cases.append((make_train_step(model, remat=True),
                  (params, init_opt_state(params),
                   {"tokens": tok[:, :St], "positions": pos[:, :St],
                    "labels": tok[:, :St]})))
    trips = []
    for fn, args in cases:
        three = roofline.analyze(fn, *args)
        every = roofline.analyze(fn, *args, every_trip=True)
        trips.append(three.loop_trips)
        assert not every.loop_trips
        assert three.dot_flops == every.dot_flops
        assert three.hbm_bytes == every.hbm_bytes
        assert three.op_counts == every.op_counts
    assert trips[0] == {
        "hymba-1.5b": {"mamba steps": 128, "mamba blocks": 5},
        "xlstm-350m": {"mlstm chunks": 5, "slstm tokens": 520}}[arch]


def test_moe_fake_width_equals_a_full_dispatch():
    """On fake tensors the grouped experts run an [E, B*C, D] buffer; a
    real run whose routing fills every expert to its capacity runs the
    same buffer: the same expert products, flop for flop."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get_smoke_config("qwen2-moe-a2.7b")
    E, k, D = cfg.moe.num_experts, cfg.moe.num_experts_per_tok, cfg.d_model
    B, S = 2, 24
    # token s prefers experts (k*s + j) % E, j = 0..k-1, in that order:
    # every expert gets S*k/E assignments a row, its capacity at cf 1
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    p["router"] = torch.eye(D, E)
    x = torch.zeros(B, S, D)
    for s in range(S):
        for j in range(k):
            x[:, s, (k * s + j) % E] = float(k - j)
    assert moe.capacity(S, k, E, 1.0) * E == S * k

    def fn(p, x):
        return moe.apply_moe(p, x, cfg, capacity_factor=1.0)

    real = roofline.analyze(fn, p, x)
    with FakeTensorMode() as mode:
        fp = {n: (mode.from_tensor(t) if isinstance(t, torch.Tensor)
                  else {m: mode.from_tensor(u) for m, u in t.items()})
              for n, t in p.items()}
        fx = mode.from_tensor(x)
    fake = roofline.analyze(fn, fp, fx)
    assert fake.dot_flops == real.dot_flops > 0
    assert fake.op_flops["aten.bmm.default"] == \
        real.op_flops["aten.bmm.default"] == \
        3 * 2 * E * (B * S * k // E) * D * cfg.moe.expert_d_ff
    # the served path's output is the per-token sum it always was
    y = fn(p, x)
    assert y.shape == x.shape and torch.isfinite(y).all()
