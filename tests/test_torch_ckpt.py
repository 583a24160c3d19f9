"""``cluster_serve --ckpt`` in the port, on the CPU.

  * The reference's ``test_ckpt_loader_restores_matching_arch_only``
    (tests/test_cluster_runtime.py) for the port's ``_load_ckpt_params``:
    a ``train_tiny``-geometry olmo-1b checkpoint restores into an olmo-1b
    node, not into xlstm-350m nor at another vocab.
  * A checkpoint the reference writes (weights and ``_vocab.json``),
    served through the port's ``build_cluster(ckpt=...)`` and the
    reference's: the same tokenizer, both nodes load the trained weights,
    and one slot's answers, qualities, contexts and sources are equal
    node for node.
  * With the quickstart's archs the xlstm-350m node prints the
    reference's mismatch line and draws its weights.
"""
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core.cluster import Query as JQuery  # noqa: E402
from repro.data.corpus import generate_corpus as j_corpus  # noqa: E402
from repro.data.tokenizer import Tokenizer as JTokenizer  # noqa: E402
from repro.launch import cluster_serve as j_serve  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.cluster import Query  # noqa: E402
from repro_torch.launch import cluster_serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import checkpoint, optimizer  # noqa: E402

KW = dict(entities=3, batch=2, max_len=192, new_tokens=4, top_k=2, seed=0)


def test_ckpt_loader_restores_matching_arch_only(tmp_path):
    vocab = 32
    cfg = get_smoke_config("olmo-1b", max_d_model=cluster_serve.CKPT_D_MODEL,
                           vocab=vocab)
    params = Model(cfg).init_params(seed=0, device="cpu", max_seq=64)
    path = str(tmp_path / "tiny.npz")
    checkpoint.save(path, params, cfg)
    loaded = cluster_serve._load_ckpt_params(path, "olmo-1b", vocab, 64,
                                             "cpu")
    assert loaded is not None
    lcfg, lparams = loaded
    assert lcfg.name == cfg.name
    for a, b in zip(optimizer.tree_leaves(lparams),
                    optimizer.tree_leaves(params)):
        assert torch.equal(a, b)
    assert cluster_serve._load_ckpt_params(path, "xlstm-350m", vocab, 64,
                                           "cpu") is None
    assert cluster_serve._load_ckpt_params(path, "olmo-1b", vocab + 1, 64,
                                           "cpu") is None


@pytest.fixture(scope="module")
def reference_ckpt(tmp_path_factory):
    """A reference-written train_tiny-geometry olmo-1b checkpoint (seeded
    weights, scaled so answers are not all one token) and its vocab."""
    docs, qas = j_corpus(KW["entities"], seed=0)
    tok = JTokenizer.build([d.text for d in docs] + [q.question for q in qas]
                           + [q.answer for q in qas]
                           + ["context : question : answer : <sep>"],
                           max_vocab=4096)
    cfg = j_smoke("olmo-1b", max_d_model=j_serve.CKPT_D_MODEL,
                  vocab=len(tok))
    params = JModel(cfg).init_params(jax.random.PRNGKey(7),
                                     max_seq=KW["max_len"])
    params = jax.tree.map(lambda a: a * 3.0, params)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.npz"
    jckpt.save(str(path), params)
    with open(str(path).replace(".npz", "_vocab.json"), "w") as f:
        json.dump(tok.vocab, f)
    return str(path)


def _slot(nodes, qas, enc, Q):
    picks = [qas[i] for i in (0, 4, 9)]
    res = []
    for node in nodes:
        qs = [Q(qa.domain, enc.encode([qa.question])[0], 40 + i,
                qa.question, qa.answer) for i, qa in enumerate(picks)]
        res.append(([(r.qid, r.answer, r.quality, r.dropped)
                     for r in node.process_slot(qs, 1e9)],
                    node.last_contexts, node.last_sources))
        node.close()
    return res


def test_reference_checkpoint_serves_like_reference(reference_ckpt, capsys):
    archs = ("olmo-1b", "olmo-1b")
    ours = cluster_serve.build_cluster(2, archs=archs, ckpt=reference_ckpt,
                                       device="cpu", **KW)
    theirs = j_serve.build_cluster(2, archs=archs, ckpt=reference_ckpt, **KW)
    out = capsys.readouterr().out
    assert out.count("loaded trained weights") == 4     # 2 nodes x 2
    assert ours[2].vocab == theirs[2].vocab
    assert ours[0][0].engine.cfg.d_model == cluster_serve.CKPT_D_MODEL
    got = _slot(ours[0], ours[1], ours[3], Query)
    want = _slot(theirs[0], theirs[1], theirs[3], JQuery)
    assert got == want
    assert len({a for node in got for _, a, _, _ in node[0]}) > 1


def test_mismatched_arch_draws_its_weights(reference_ckpt, capsys):
    nodes = cluster_serve.build_cluster(2, ckpt=reference_ckpt, device="cpu",
                                        **KW)[0]
    out = capsys.readouterr().out
    assert f"node 0 [olmo-1b]: loaded trained weights from {reference_ckpt}" \
        in out
    assert "node 1 [xlstm-350m]: ckpt arch/shape mismatch — random init" \
        in out
    assert nodes[1].engine.cfg.d_model == 32       # the smoke width
    for node in nodes:
        node.close()
