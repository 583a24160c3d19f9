"""Roofline terms of the port's per-rank program, counted from a trace of
it on fake tensors, with the constants of one NVIDIA H100.

Counterpart of ``repro/launch/roofline.py``, which parses compiled HLO.
PyTorch runs eagerly and has no HLO: ``analyze(fn, *args)`` runs ``fn``
once on ``FakeTensorMode`` tensors (nothing is allocated and no kernel
is launched) under a ``TorchDispatchMode`` that sees every aten
operation after autograd, those of the backward pass too, and counts

  * flops: ``torch.utils.flop_counter``'s formulas (matrix products,
    convolutions, attention);
  * HBM bytes: each op's tensor operands plus its outputs.  A view moves
    nothing and is not counted.  The reference's region rule holds for
    indexed access: a read (``index``, ``gather``, ``index_select``,
    ``embedding``) counts its output twice, a write (``index_put``,
    ``scatter``, ``index_copy``, ``copy_`` into a view) its update
    twice;
  * collective bytes: the operand bytes of each ``c10d`` op, under the
    reference's names (``all-reduce``, ``all-gather``, ...);
  * ``op_counts`` and ``op_flops``: the ops, and their flops, by name.

Each kernel wrapper of ``kernels.ops`` is one op.  While a trace runs,
the tracer stands in for ``ops.flash_attention``,
``ops.paged_decode_attention``, ``ops.retrieval_topk`` and
``ops.ivf_retrieval_topk`` (the module attributes the models call; put
back afterwards, so the served path is untouched): it runs the plain
version uncounted and counts the kernel's flops by the formula of
``chip_smoke.py``'s bound column, its bytes as its inputs and outputs,
and its outputs' memory only.  Flash's gradient is counted likewise, as
``flash_attention_bwd``.  Positions are data, which a fake tensor does
not hold, so a flash call's (query, key) pairs are those of queries
right-aligned to the keys: all of them for a prefill, the whole buffer
for a decode step over it.

The recurrent layers' loops (``models.loops``) run three trips and the
tracer counts the middle one as the trips it stands for, in the
forward pass and, through the autograd nodes it made, in the backward
pass: the reference's while-body weighting by trip count.
``TraceStats.loop_trips`` records each loop's trips.

Memory: the peak of the live bytes of the storages the trace creates
(each storage once, whatever its views), ``peak_bytes``.  A loop counts
the trips it did not run in its output list, not in their temporaries.

The program traced is one rank's, so every count is PER RANK and the
three terms come out in per-card seconds:

  compute    = dot_flops / PEAK_FLOPS
  memory     = hbm_bytes / HBM_BW        (or the analytic model's bytes)
  collective = collective_bytes / NET_BW
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

# NVIDIA H100 SXM5, dense BF16 on the tensor cores: 989 TFLOP/s (the
# H100 data sheet gives 1,979 with 2:4 sparsity, twice the dense rate).
PEAK_FLOPS = 989e12
# NVIDIA H100 SXM5 HBM3: 3.35 TB/s (H100 data sheet).
HBM_BW = 3.35e12
# The network a collective of the production mesh crosses: one NDR
# InfiniBand port of 400 Gb/s per GPU (ConnectX-7), as in NVIDIA's DGX
# H100 (eight GPUs, eight such ports), so 50 GB/s each way per GPU.
# Every axis of the 16x16 and 2x16x16 meshes spans more than one
# eight-GPU node, so its collectives are bound by this figure, not by
# NVLink 4 inside a node (450 GB/s per direction per GPU), which this
# model does not use.  The figure comes from the port's hardware; it is
# not carried over from the reference's TPU interconnect constant
# (``src/repro/launch/roofline.py:33-35``), which happens to be the same
# number.
NET_BW = 50e9

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the c10d ops of torch.distributed's collectives -> (the reference's
# name, the index of the argument that holds the operand)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
}

# indexed reads (the region rule: output twice) and writes (update twice,
# the update at this argument index)
_READS = {"index", "gather", "index_select", "embedding", "take",
          "_unsafe_index"}
_WRITES = {"copy_": 1, "index_put_": 2, "index_put": 2,
           "_index_put_impl_": 2, "scatter_": 3, "scatter": 3,
           "scatter_add_": 3, "scatter_add": 3, "scatter_reduce_": 3,
           "scatter_reduce": 3, "index_copy_": 3, "index_copy": 3,
           "index_add_": 3, "index_add": 3, "masked_scatter_": 2}
# no data moved: allocation, metadata and bookkeeping
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "device", "alias",
         "_unsafe_view",
         "_local_scalar_dense", "set_", "resize_", "record_stream"}


def type_bytes(dtype, shape: Sequence[int] = ()) -> int:
    """Bytes of a tensor of ``dtype`` and ``shape``: the counterpart of
    the reference's HLO type string (``f32[8,64]`` is ``(torch.float32,
    (8, 64))``)."""
    import torch
    n = 1
    for d in shape:
        n *= int(d)
    if dtype == torch.bool:
        return n
    return n * (torch.finfo(dtype).bits if dtype.is_floating_point
                else torch.iinfo(dtype).bits) // 8


@dataclass
class TraceStats:
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = field(default_factory=dict)
    op_counts: Dict[str, float] = field(default_factory=dict)
    op_flops: Dict[str, float] = field(default_factory=dict)
    loop_trips: Dict[str, int] = field(default_factory=dict)
    peak_bytes: float = 0.0        # live bytes the trace created, at most
    output_bytes: float = 0.0      # the result's storages, not arguments'
    alias_bytes: float = 0.0       # the result's storages that are inputs'


def _tensors(tree) -> list:
    """The tensors of a pytree, those of its dataclass leaves (a
    ``models.cache.Cache``) included."""
    import torch
    from torch.utils._pytree import tree_leaves
    out = []
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            out += _tensors([getattr(x, f.name)
                             for f in dataclasses.fields(x)])
    return out


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (views once)."""
    seen = {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in _tensors(tree)}
    return sum(seen.values())


def _nbytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


class _Tracer:
    """The counters, the loop weights and the live storages of one trace;
    ``mode()`` is the ``TorchDispatchMode`` that feeds them."""

    def __init__(self):
        self.stats = TraceStats()
        self._stack = [1.0]       # forward weights (cumulative) of the loops
        self._ranges = []         # (lo, hi, weight): autograd nodes made
        self._index = None        # the ranges sorted, for lookups
        self._suspended = 0
        self._refs: Dict[int, object] = {}
        self._live = 0.0
        self._kinds: Dict[object, tuple] = {}
        from torch.utils.flop_counter import flop_registry
        self._flop_fns = flop_registry

    # ---------------------------------------------------------- weights

    @contextlib.contextmanager
    def weighted(self, n: int, name: str, trips: int):
        """The ops inside count ``n`` times (times the enclosing loops'),
        and so do, in the backward pass, those of the autograd nodes
        made inside."""
        import torch
        w = self._stack[-1] * n
        self.stats.loop_trips[name] = max(
            trips, self.stats.loop_trips.get(name, 0))
        lo = torch._C._autograd._get_sequence_nr()
        self._stack.append(w)
        try:
            yield
        finally:
            self._stack.pop()
            self._ranges.append((lo, torch._C._autograd._get_sequence_nr(),
                                 w))
            self._index = None

    def weight(self) -> float:
        if len(self._stack) > 1:
            return self._stack[-1]
        if not self._ranges:
            return 1.0
        import torch
        node = torch._C._current_autograd_node()
        if node is None:
            return 1.0
        return self._node_weight(node._sequence_nr())

    def _node_weight(self, seq: int) -> float:
        """The weight of the innermost range that holds ``seq``: ranges
        nest or are disjoint, so walking back from the last that starts
        at or before ``seq`` finds it first."""
        if self._index is None:
            rs = sorted(self._ranges)
            reach, hi_max = [], 0
            for _, hi, _ in rs:
                hi_max = max(hi_max, hi)
                reach.append(hi_max)
            self._index = ([r[0] for r in rs], rs, reach)
        los, rs, reach = self._index
        j = bisect_right(los, seq) - 1
        while j >= 0 and reach[j] > seq:
            if rs[j][1] > seq:
                return rs[j][2]
            j -= 1
        return 1.0

    @contextlib.contextmanager
    def suspended(self):
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    # ----------------------------------------------------------- memory

    def known(self, tree) -> None:
        """Storages that exist before the trace: not the trace's bytes."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            self._refs.setdefault(id(st), st)

    def _track(self, tree) -> None:
        """Count the new storages of ``tree`` live until they are freed."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            k = id(st)
            if k in self._refs:
                continue
            nb = st.nbytes()
            self._refs[k] = weakref.ref(st, functools.partial(
                self._freed, k, nb))
            self._live += nb
            self.stats.peak_bytes = max(self.stats.peak_bytes, self._live)

    def _freed(self, k: int, nb: int, _ref) -> None:
        if self._refs.pop(k, None) is not None:
            self._live -= nb

    def fill(self, outs: list, n: int) -> list:
        """``models.loops.full``: [first, middle, middle' x (n - 3),
        last], middle' the middle trip's output detached, its memory
        counted n - 3 times while the list lives."""
        first, mid, last = outs
        with self.suspended():
            filler = mid.detach()
        nb = mid.numel() * mid.element_size() * (n - 3)
        self._live += nb
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._live)
        weakref.finalize(filler, self._release, nb)
        return [first, mid] + [filler] * (n - 3) + [last]

    def _release(self, nb: int) -> None:
        self._live -= nb

    # ---------------------------------------------------------- counting

    def _kind(self, func) -> tuple:
        kind = self._kinds.get(func)
        if kind is None:
            ns, name = func.namespace, func._schema.name.split("::")[-1]
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns)
            if ns == "c10d" and name in _C10D:
                kind = ("coll",) + _C10D[name]
            elif view or name in _FREE or ns == "prim":
                kind = ("free",)
            elif name in _READS:
                kind = ("read",)
            elif name in _WRITES:
                kind = ("write", _WRITES[name])
            else:
                kind = ("op",)
            self._kinds[func] = kind
        return kind

    def count(self, func, args, kwargs, out) -> None:
        kind = self._kind(func)
        if kind[0] == "free":
            return
        w = self.weight()
        s = self.stats
        key = str(func)
        s.op_counts[key] = s.op_counts.get(key, 0.0) + w
        outs = _tensors(out)
        if kind[0] == "read":
            b = 2 * _nbytes(outs)
        elif kind[0] == "write":
            upd = args[kind[1]] if len(args) > kind[1] else None
            b = 2 * _nbytes(_tensors(upd)) if upd is not None \
                else _nbytes(outs)
        else:
            b = _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
        s.hbm_bytes += w * b
        if kind[0] == "coll":
            _, name, at = kind
            cb = _nbytes(_tensors(args[at])) if len(args) > at else 0.0
            s.collective_bytes += w * cb
            s.per_collective[name] = s.per_collective.get(name, 0.0) + w * cb
        fn = self._flop_fns.get(func._overloadpacket)
        if fn is not None:
            f = w * fn(*args, **kwargs, out_val=out)
            s.dot_flops += f
            s.op_flops[key] = s.op_flops.get(key, 0.0) + f
        self._track(out)

    def kernel(self, name: str, flops: float, inputs, outputs,
               nbytes: Optional[float] = None) -> None:
        """One launch of a hand-written kernel: ``flops``, and ``nbytes``
        (default: its inputs plus its outputs)."""
        w = self.weight()
        s = self.stats
        key = f"kernel.{name}"
        s.op_counts[key] = s.op_counts.get(key, 0.0) + w
        if nbytes is None:
            nbytes = _nbytes(_tensors(inputs)) + _nbytes(_tensors(outputs))
        s.hbm_bytes += w * nbytes
        s.dot_flops += w * flops
        s.op_flops[key] = s.op_flops.get(key, 0.0) + w * flops
        self._track(outputs)

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        tracer = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if not tracer._suspended:
                    tracer.count(func, args, kwargs, out)
                return out

        return _Mode()


# ------------------------------------------------------------------ kernels


def flash_pairs(B: int, Sq: int, Sk: int, causal: bool = True,
                window: Optional[int] = None) -> int:
    """(query, key) pairs one flash call attends, queries right-aligned
    to the keys (query i sees keys up to Sk - Sq + i): a prefill's Sq =
    Sk, a decode step's one query over its whole buffer."""
    if not causal:
        return B * Sq * Sk
    a = Sk - Sq + 1                       # keys query 0 sees
    if not window:
        return B * (Sq * a + Sq * (Sq - 1) // 2)
    m = min(max(window - a, 0), Sq)       # queries below the window
    return B * (m * a + m * (m - 1) // 2 + (Sq - m) * window)


def _kernel_wrappers(tracer: _Tracer) -> dict:
    """Stand-ins for the ``ops`` wrappers: the plain version, uncounted,
    and one counted op."""
    import torch
    from repro_torch.kernels import ref

    class Flash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, softcap):
            B, Sq, H, hd = q.shape
            with tracer.suspended():
                out = ref.flash_attention_ref(q, k, v, q_pos, kv_pos,
                                              causal=causal, window=window,
                                              softcap=softcap)
                lse = q.new_empty((B, H, Sq), dtype=torch.float32) \
                    if ctx.needs_input_grad[0] or ctx.needs_input_grad[1] \
                    else None
            pairs = flash_pairs(B, Sq, k.shape[1], causal, window)
            ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
            ctx.opts = (causal, window, softcap, pairs)
            tracer.kernel("flash_attention", 4 * H * hd * pairs,
                          (q, k, v, q_pos, kv_pos), (out, lse))
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
            causal, window, softcap, pairs = ctx.opts
            with tracer.suspended():
                dq, dk, dv = ref.flash_attention_bwd_ref(
                    q, k, v, q_pos, kv_pos, dout, causal=causal,
                    window=window, softcap=softcap)
            H, hd = q.shape[2], q.shape[3]
            tracer.kernel("flash_attention_bwd", 10 * H * hd * pairs,
                          (q, k, v, q_pos, kv_pos, out, dout, lse),
                          (dq, dk, dv))
            return dq, dk, dv, None, None, None, None, None

    def flash_attention(q, k, v, q_pos, kv_pos, causal=True, window=None,
                        softcap=None):
        return Flash.apply(q, k, v, q_pos, kv_pos, causal, window, softcap)

    def paged_decode_attention(q, k_pool, v_pool, block_tables, first, last,
                               softcap=None):
        with tracer.suspended():
            out = ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                          first, last, softcap=softcap)
        B, H, hd = q.shape
        slots = B * block_tables.shape[1] * k_pool.shape[1]
        region = 2 * slots * k_pool.shape[2] * hd * k_pool.element_size()
        tracer.kernel("paged_decode_attention", 4 * H * hd * slots,
                      (q, block_tables, first, last), out,
                      nbytes=region + _nbytes([q, block_tables, first, last,
                                               out]))
        return out

    def retrieval_topk(queries, docs, k):
        with tracer.suspended():
            out = ref.topk_ref(queries, docs, k)
        tracer.kernel("retrieval_topk",
                      2 * queries.shape[0] * docs.shape[0] * docs.shape[1],
                      (queries, docs), out)
        return out

    def ivf_retrieval_topk(queries, list_emb, list_ids, probe_ids, k):
        with tracer.suspended():
            out = ref.ivf_topk_ref(queries, list_emb, list_ids, probe_ids, k)
        rows = probe_ids.numel() * list_emb.shape[1]
        D = list_emb.shape[2]
        tracer.kernel("ivf_retrieval_topk", 2 * D * rows,
                      (queries, probe_ids), out,
                      nbytes=rows * (D * list_emb.element_size() + 4)
                      + _nbytes([queries, probe_ids]) + _nbytes(out))
        return out

    return {"flash_attention": flash_attention,
            "paged_decode_attention": paged_decode_attention,
            "retrieval_topk": retrieval_topk,
            "ivf_retrieval_topk": ivf_retrieval_topk}


@contextlib.contextmanager
def _tracing(tracer: _Tracer, every_trip: bool):
    from repro_torch.kernels import ops
    from repro_torch.models import loops
    saved = {name: getattr(ops, name) for name in _kernel_wrappers(tracer)}
    old = loops.TRACER
    try:
        for name, fn in _kernel_wrappers(tracer).items():
            setattr(ops, name, fn)
        loops.TRACER = None if every_trip else tracer
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
        loops.TRACER = old


def analyze(fn, *args, every_trip: bool = False) -> TraceStats:
    """Run ``fn(*args)`` once and count it (the module docstring).

    Arguments made under a ``FakeTensorMode`` (``launch.specs
    .build_step``'s) run under that mode: nothing is allocated.  Real
    CPU tensors run for real, which small checks use.  ``every_trip``
    runs every trip of the recurrent loops instead of three."""
    from torch._guards import detect_fake_mode
    fake = detect_fake_mode(args)
    tracer = _Tracer()
    tracer.known(args)
    arg_keys = {id(t.untyped_storage()) for t in _tensors(args)}
    with contextlib.ExitStack() as stack:
        if fake is not None:
            stack.enter_context(fake)
        stack.enter_context(_tracing(tracer, every_trip))
        stack.enter_context(tracer.mode())
        out = fn(*args)
    outs = _tensors(out)
    tracer.stats.output_bytes = float(storage_bytes(
        [t for t in outs if id(t.untyped_storage()) not in arg_keys]))
    tracer.stats.alias_bytes = float(storage_bytes(
        [t for t in outs if id(t.untyped_storage()) in arg_keys]))
    return tracer.stats


# ---------------------------------------------------------------- models


def analytic_memory_bytes(cfg, shape, meta: Dict) -> float:
    """Per-rank HBM traffic model of a well-fused program on the card.

    The traced byte count (``TraceStats.hbm_bytes``) counts every aten
    operation's operands and outputs: eager PyTorch fuses nothing, so it
    is a loose upper bound.  On the card the flash kernels keep their
    score tiles in shared memory and registers, and a fused program
    would keep elementwise chains there too.  This model counts what
    such a program must move per step (the reference's arithmetic):

      weights (x3 for fwd/remat/bwd, per microbatch), AdamW state r/w,
      layer-boundary activations (+remat residual save/restore), flash
      K/V streaming (K,V re-read once per Q tile), decode cache reads,
      logits.
    """
    p_loc = meta["param_bytes_per_dev"]
    b_loc = meta["batch_per_dev"]
    n_l = cfg.num_layers
    d = cfg.d_model
    S = shape.seq_len
    act = 2  # bf16
    if shape.mode == "train":
        micro = meta.get("microbatch", 1)
        b_mb = max(1, b_loc // micro)
        q_blk = 512
        nq = max(1, min(S, 4096) // q_blk)
        kv_bytes = S * cfg.num_kv_heads * cfg.resolved_head_dim * act
        weights = micro * 3 * p_loc                 # fwd + remat + bwd reads
        # mu/nu read and written, grads, params written
        opt = p_loc / 2 * 4 * 4 + p_loc / 2 * 4 * 2 + 2 * p_loc
        acts = micro * (n_l * b_mb * S * d * act * (3 * 2 + 2))
        attn = (micro * 3 * n_l * b_mb * 2 * kv_bytes * nq
                / meta.get("kv_shards", 1))
        logits = 3 * b_loc * S * meta["vocab_loc"] * 4
        return weights + opt + acts + attn + logits
    if shape.mode == "prefill":
        q_blk = 512
        nq = max(1, S // q_blk)
        kv_bytes = S * cfg.num_kv_heads * cfg.resolved_head_dim * act
        cache_w = meta.get("cache_bytes_per_dev", 0.0)
        return (p_loc + n_l * b_loc * S * d * act * 2
                + n_l * b_loc * 2 * kv_bytes * nq / meta.get("kv_shards", 1)
                + cache_w)
    # decode: weights + full cache read + tiny writes
    return (p_loc + meta.get("cache_bytes_per_dev", 0.0)
            + b_loc * d * n_l * act * 4)


def roofline_terms(stats: TraceStats, *, model_flops_global: float,
                   chips: int, analytic_bytes: Optional[float] = None
                   ) -> Dict[str, float]:
    """Terms in per-card seconds + bookkeeping ratios."""
    compute_t = stats.dot_flops / PEAK_FLOPS
    mem_bytes = analytic_bytes if analytic_bytes is not None \
        else stats.hbm_bytes
    memory_t = mem_bytes / HBM_BW
    coll_t = stats.collective_bytes / NET_BW
    dom = max((compute_t, "compute"), (memory_t, "memory"),
              (coll_t, "collective"))[1]
    hlo_flops_global = stats.dot_flops * chips
    return {
        "compute_s": compute_t,
        "memory_s": memory_t,
        "memory_hlo_upper_s": stats.hbm_bytes / HBM_BW,
        "collective_s": coll_t,
        "dominant": dom,
        "model_flops": model_flops_global,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": (model_flops_global / hlo_flops_global
                               if hlo_flops_global else 0.0),
    }


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); D = tokens processed, and a
    1/3 factor for inference shapes (forward only)."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch      # decode: 1 token/seq

