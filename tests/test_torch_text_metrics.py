"""The port's text metrics (``repro_torch.metrics``) against the
reference's ``repro.metrics.text`` on fixed strings, the empty string
included: ROUGE-1/2, BLEU-4, METEOR, ROUGE-L (both normalisations),
BERTScore and the composite quality, equal to the last bit (the same
Python arithmetic; BERTScore's numpy sums in the same order)."""
import pytest

pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.metrics import text as jtext  # noqa: E402

from repro_torch import metrics  # noqa: E402

PAIRS = [
    ("the capital of france is paris", "paris is the capital of france"),
    ("alpha beta gamma delta", "alpha beta gamma delta"),
    ("running jumped quickly boxes", "run jump quick box"),
    ("a b a b a b", "a b"),
    ("one", "one two three four five"),
    ("", "some reference answer"),
    ("some generated answer", ""),
    ("", ""),
    ("entity 7 founded the lab in 1999 .", "the lab was founded in 1999"),
]
NAMES = ["rouge_n", "bleu4", "meteor", "rouge_l", "bertscore",
         "composite_quality"]


@pytest.mark.parametrize("name", NAMES)
def test_metric_matches_reference(name):
    ours, theirs = getattr(metrics, name), getattr(jtext, name)
    for gen, ref in PAIRS:
        assert ours(gen, ref) == theirs(gen, ref), (name, gen, ref)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_rouge_n_orders_match_reference(n):
    for gen, ref in PAIRS:
        assert metrics.rouge_n(gen, ref, n=n) == jtext.rouge_n(gen, ref, n=n)


def test_variants_match_reference():
    for gen, ref in PAIRS:
        assert metrics.rouge_l(gen, ref, paper_norm=False) == \
            jtext.rouge_l(gen, ref, paper_norm=False)
        assert metrics.meteor(gen, ref, alpha=0.5, beta=2.0, gamma=0.3) == \
            jtext.meteor(gen, ref, alpha=0.5, beta=2.0, gamma=0.3)
