"""Answer-quality metrics of the port (copies of the reference's)."""
from repro_torch.metrics.text import (bertscore, bleu4,  # noqa: F401
                                      composite_quality, meteor, rouge_l,
                                      rouge_n)
