"""Synthetic multi-domain corpora + QA pairs (DomainQA-style, §V-A).

Six domains (biomedicine, finance, law, sports, technology, travel),
each with its own entity/attribute/value vocabulary.  Documents are
factual statements about entities; QA pairs ask for an attribute of an
entity whose answer is verbatim in exactly one document — the
single-document-query setting the paper evaluates, with a real retrieval
signal (the answer is NOT inferable without the right chunk).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

DOMAINS = ["biomedicine", "finance", "law", "sports", "technology", "travel"]

_BANKS: Dict[str, Tuple[List[str], List[str], List[str]]] = {
    # domain: (entity stems, attributes, value words)
    "biomedicine": (
        ["enzyme", "protein", "pathogen", "antibody", "receptor", "genome"],
        ["dosage", "halflife", "target", "pathway", "mutation"],
        ["kinase", "plasma", "membrane", "sequence", "inhibitor", "ligand",
         "antigen", "clinical", "therapeutic", "cellular"]),
    "finance": (
        ["bond", "equity", "fund", "portfolio", "derivative", "index"],
        ["yield", "maturity", "rating", "exposure", "premium"],
        ["basis", "hedge", "liquidity", "dividend", "futures", "margin",
         "treasury", "coupon", "arbitrage", "volatility"]),
    "law": (
        ["statute", "contract", "tribunal", "plaintiff", "clause", "verdict"],
        ["jurisdiction", "liability", "precedent", "remedy", "damages"],
        ["appellate", "binding", "tort", "equity", "injunction", "counsel",
         "discovery", "testimony", "negligence", "covenant"]),
    "sports": (
        ["striker", "league", "marathon", "tournament", "goalkeeper",
         "relay"],
        ["record", "transfer", "ranking", "score", "coach"],
        ["penalty", "sprint", "champion", "stadium", "offside", "podium",
         "fixture", "overtime", "dribble", "medal"]),
    "technology": (
        ["compiler", "protocol", "database", "processor", "router",
         "kernel"],
        ["latency", "throughput", "version", "cache", "bandwidth"],
        ["packet", "thread", "pipeline", "register", "socket", "runtime",
         "buffer", "scheduler", "firmware", "silicon"]),
    "travel": (
        ["airline", "harbor", "monument", "resort", "railway", "museum"],
        ["altitude", "season", "currency", "visa", "route"],
        ["island", "summit", "lagoon", "terminal", "voyage", "heritage",
         "plateau", "carnival", "glacier", "bazaar"]),
}


@dataclass
class Document:
    doc_id: int
    domain: int
    text: str
    entity: str


@dataclass
class QAPair:
    qid: int
    domain: int
    question: str
    answer: str
    doc_id: int


def generate_domain_corpus(domain: int, n_entities: int = 40,
                           seed: int = 0) -> Tuple[List[Document],
                                                   List[QAPair]]:
    name = DOMAINS[domain]
    stems, attrs, values = _BANKS[name]
    rng = np.random.default_rng(seed + domain * 1000)
    docs: List[Document] = []
    qas: List[QAPair] = []
    for i in range(n_entities):
        entity = f"{rng.choice(stems)} {name[:4]}{i}"
        sentences = []
        chosen = rng.choice(len(attrs), size=3, replace=False)
        for ai in chosen:
            attr = attrs[ai]
            val = " ".join(rng.choice(values, size=2, replace=False))
            sentences.append(f"the {attr} of {entity} is {val} .")
        text = f"in {name} , " + " ".join(sentences)
        doc = Document(len(docs), domain, text, entity)
        docs.append(doc)
        # one QA per entity over a random covered attribute
        ai = int(rng.choice(chosen))
        attr = attrs[ai]
        # recover the value from the sentence
        sent = sentences[list(chosen).index(ai)]
        val = sent.split(" is ")[1].rstrip(" .")
        qas.append(QAPair(0, domain,
                          f"what is the {attr} of {entity} ?",
                          f"the {attr} of {entity} is {val} .",
                          doc.doc_id))
    return docs, qas


def generate_corpus(n_entities_per_domain: int = 40, seed: int = 0
                    ) -> Tuple[List[Document], List[QAPair]]:
    """All six domains; doc_ids and qids globally unique."""
    docs: List[Document] = []
    qas: List[QAPair] = []
    for d in range(len(DOMAINS)):
        dd, qq = generate_domain_corpus(d, n_entities_per_domain, seed)
        offset = len(docs)
        for doc in dd:
            doc.doc_id += offset
            docs.append(doc)
        for qa in qq:
            qa.doc_id += offset
            qa.qid = len(qas)
            qas.append(qa)
    return docs, qas
