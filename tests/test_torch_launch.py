"""The port's ``cluster_serve`` launcher on the CPU: ``build_cluster``
against the reference's for the same arguments (tokenizer, shards,
coverage, archs, identifier), equal answers, contexts and sources from
one slot when the port is handed the reference's weights through
``models=``, the README's and CI's commands through ``main`` with
``--device cpu`` (their traces pass ``tools/trace_report.py --check`` and
the metrics self-probe prints OK), four nodes (the reference's whole
node cycle: olmo-1b, xlstm-350m, hymba-1.5b, qwen2-moe-a2.7b) built and
serving a slot as the reference's do, ``--ckpt`` (ported with training)
reaching ``build_cluster``, and ``launch.train --production-mesh``
(ported with the distributed layer) refusing a world of one, naming its
size and the 256 ranks the 16x16 mesh needs, before the model is
built."""
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.core.cluster import Query as JQuery  # noqa: E402
from repro.launch import cluster_serve as j_serve  # noqa: E402

from repro_torch import bridge, obs  # noqa: E402
from repro_torch.core.cluster import Query  # noqa: E402
from repro_torch.launch import cluster_serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the README quickstart's cluster command (README.md, CI docs-check)
README = ["--smoke", "--nodes", "2", "--slots", "2", "--standing",
          "--paged", "--admission", "sjf", "--federated", "--metrics-every",
          "1", "--metrics-port", "0"]
# the CI saturation smoke (.github/workflows/ci.yml)
CI = ["--smoke", "--nodes", "2", "--slots", "4", "--per-slot", "12",
      "--standing", "--paged", "--trace", "spike", "--metrics-port", "0",
      "--require-healthy-exit"]
KW = dict(entities=3, batch=2, max_len=192, new_tokens=4, top_k=2, seed=0,
          federated=True, cache=True, queue="standing", paged=True,
          admission="sjf")


@pytest.fixture(scope="module")
def clusters():
    """(port build, reference build) for the same arguments; the port's
    nodes are handed the reference's weights through ``models=``."""
    theirs = j_serve.build_cluster(2, **KW)
    models = [(n.engine.cfg, bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, n.engine.params), n.engine.cfg,
        device="cpu")) for n in theirs[0]]
    ours = cluster_serve.build_cluster(2, models=models, device="cpu", **KW)
    return ours, theirs


def test_build_cluster_matches_reference(clusters):
    (nodes, qas, tok, enc, ident, cov), \
        (j_nodes, j_qas, j_tok, j_enc, j_ident, j_cov) = clusters
    assert tok.vocab == j_tok.vocab
    assert [qa.question for qa in qas] == [qa.question for qa in j_qas]
    assert [[d.doc_id for d in n.docs] for n in nodes] == \
        [[d.doc_id for d in n.docs] for n in j_nodes]
    np.testing.assert_array_equal(cov, j_cov)
    assert [n.arch for n in nodes] == [n.arch for n in j_nodes] == \
        ["olmo-1b", "xlstm-350m"]
    assert (ident.n_nodes, ident.update_threshold) == \
        (j_ident.n_nodes, j_ident.update_threshold)
    assert enc.dim == j_enc.dim
    assert nodes[0].federation is nodes[1].federation is not None
    assert [n.queue_kind for n in nodes] == ["standing"] * 2
    assert [n.engine.max_len for n in nodes] == \
        [n.engine.max_len for n in j_nodes]
    # drawn weights: seed + n per node, on the requested device
    drawn = cluster_serve.build_cluster(2, device="cpu", **KW)[0]
    assert drawn[0].engine.params["embed"].device.type == "cpu"
    assert not torch.equal(drawn[0].engine.params["embed"],
                           nodes[0].engine.params["embed"])
    with pytest.raises(ValueError, match="models"):
        cluster_serve.build_cluster(2, models=[], device="cpu", **KW)


def test_one_slot_matches_reference(clusters):
    (nodes, qas, _, enc, _, _), (j_nodes, _, _, j_enc, _, _) = clusters
    picks = [qas[i] for i in (0, 4, 9, 4, 13)]
    out = {}
    for port, ns, e in ((True, nodes, enc), (False, j_nodes, j_enc)):
        Q = Query if port else JQuery
        res = []
        for node in ns:
            qs = [Q(qa.domain, e.encode([qa.question])[0], 40 + i,
                    qa.question, qa.answer) for i, qa in enumerate(picks)]
            res.append(([(r.qid, r.answer, r.quality, r.dropped)
                         for r in node.process_slot(qs, 1e9)],
                        node.last_contexts, node.last_sources,
                        node.unfinished()))
            node.close()
        out[port] = res
    assert out[True] == out[False]
    assert all(r[3] == 0 for r in out[True])


def _check_cli(path) -> str:
    res = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "trace_report.py"),
                          str(path), "--check"], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


@pytest.mark.parametrize("argv", [README + ["--per-slot", "8"], CI],
                         ids=["readme", "ci"])
def test_main_runs_the_documented_commands(argv, tmp_path, capsys):
    trace = tmp_path / "trace.jsonl"
    cluster_serve.main(argv + ["--trace-out", str(trace), "--device",
                               "cpu"])
    out = capsys.readouterr().out
    assert "summary:" in out and "metrics probe: OK" in out
    assert "standing: 0 request(s) unfinished at exit" in out
    assert "OK:" in _check_cli(trace)
    # the run leaves no switch on behind it
    assert not obs.enabled() and not obs.metrics_enabled()


class _Reached(Exception):
    """``build_cluster`` was called (with these keyword arguments)."""


@pytest.mark.parametrize("launcher,extra", [
    ("cluster_serve", ["--paged", "--ckpt", "tiny.npz"]),
    ("train", ["--production-mesh"]),
], ids=["ckpt", "production-mesh"])
def test_unported_flags_raise_before_building(launcher, extra, monkeypatch):
    """The flags that raised ``NotImplementedError`` until their slices
    were ported.  ``--ckpt`` (A6) now hands its path to
    ``build_cluster``.  ``--production-mesh`` (A7a) runs the sharded
    program over the 16x16 mesh: in a world of one it raises the world-size
    error, naming 1 and the 256 ranks it needs, before the model is built
    or a process group started."""
    seen = {}

    def reached(*args, **kw):
        seen.update(kw)
        raise _Reached

    def boom(*args, **kw):
        raise AssertionError("the model was built")

    if launcher == "train":
        import torch.distributed as dist
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        monkeypatch.setattr(train, "Model", boom)
        with pytest.raises(RuntimeError,
                           match=r"world of 256 ranks.*this world has 1 "):
            train.main(["--smoke", "--device", "cpu"] + extra)
        assert not dist.is_initialized()
        return
    monkeypatch.setattr(cluster_serve, "build_cluster", reached)
    with pytest.raises(_Reached):
        cluster_serve.main(["--smoke", "--device", "cpu"] + extra)
    assert seen["ckpt"] == "tiny.npz" and seen["paged"]
    assert not obs.metrics_enabled()


def test_four_nodes_build_and_serve_like_reference():
    """``--nodes 4`` builds the reference's whole node cycle (the archs
    that raised before hymba-1.5b and qwen2-moe-a2.7b were ported) and,
    handed the reference's weights, each node answers a slot as the
    reference's does (the non-paged continuous queue, the default)."""
    kw = dict(entities=3, batch=2, max_len=192, new_tokens=4, top_k=2,
              seed=0)
    cluster_serve.check_ported(4)
    theirs = j_serve.build_cluster(4, **kw)
    models = [(n.engine.cfg, bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, n.engine.params), n.engine.cfg,
        device="cpu")) for n in theirs[0]]
    ours = cluster_serve.build_cluster(4, models=models, device="cpu", **kw)
    assert [n.arch for n in ours[0]] == [n.arch for n in theirs[0]] \
        == list(cluster_serve.NODE_ARCHS)
    picks = [ours[1][i] for i in (0, 4, 4)]
    out = {}
    for port, (nodes, _, _, enc, _, _) in ((True, ours), (False, theirs)):
        Q = Query if port else JQuery
        res = []
        for node in nodes:
            qs = [Q(qa.domain, enc.encode([qa.question])[0], 40 + i,
                    qa.question, qa.answer) for i, qa in enumerate(picks)]
            res.append(([(r.qid, r.answer, r.quality, r.dropped)
                         for r in node.process_slot(qs, 1e9)],
                        node.last_contexts, node.last_sources))
        out[port] = res
    assert out[True] == out[False]


def test_cuda_device_without_gpu_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")

    def boom(*args, **kw):
        raise AssertionError("build_cluster ran")

    monkeypatch.setattr(cluster_serve, "build_cluster", boom)
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster_serve.main(["--smoke", "--paged", "--standing"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster_serve.main(["--smoke", "--paged", "--device", "cuda"])
