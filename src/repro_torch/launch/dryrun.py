"""Multi-pod dry-run: trace every (arch x input-shape) pair's per-rank
program on the production mesh and record memory, counts and roofline
terms, with nothing allocated.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each pair on 512 placeholder devices.  Here the process joins a fake
world of the mesh's size (``torch.distributed``'s ``"fake"`` backend
from ``torch.testing._internal.distributed.fake_pg``: collectives are
accepted and move nothing), builds the production mesh over it with
``device_type="cpu"``, builds the pair with ``launch.specs.build_step``
and traces it once with ``launch.roofline.analyze`` on fake tensors.
Importing this module sets no environment variable and touches no
process group; ``run_pair`` joins the world it needs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--multi-pod | --both-meshes] [--out DIR]

writes one JSON record a pair under ``--out`` (default
``experiments/dryrun_torch``); ``launch.report`` tabulates them.
"""
import argparse
import json
import os
import time
import traceback

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 shape_applicable)
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.launch.specs import build_step

_MESHES = {}   # multi_pod -> the production DeviceMesh of the fake world


def fake_world(multi_pod: bool):
    """The production mesh (16x16, or 2x16x16 with ``multi_pod``) over a
    fake world of its size, this process rank 0: joined (and the mesh
    built) on first use, a world of another size left first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    want = production_shape(multi_pod).size
    if dist.is_initialized() and dist.get_world_size() != want:
        dist.destroy_process_group()
        _MESHES.clear()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=want)
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = make_production_mesh(multi_pod,
                                                  device_type="cpu")
    return _MESHES[multi_pod]


def argument_bytes(shape, args, meta) -> int:
    """Per-rank bytes of the step's arguments before it runs (a step
    replaces the cache's recurrent state): params, optimizer state, the
    batch (a training rank's rows of the global batch it is handed) and
    the cache."""
    if shape.mode != "train":
        return roofline.storage_bytes(args)
    params, opt, batch = args
    rows = meta["batch_per_dev"] / shape.global_batch
    return roofline.storage_bytes((params, opt)) \
        + int(roofline.storage_bytes(batch) * rows)


def trace_pair(cfg, shape, mesh, chips: int) -> dict:
    """A pair's record fields: ``meta``, ``trace_s`` (building and
    tracing), ``memory`` (per-rank bytes: the arguments, the trace's
    peak above them as ``temp_bytes``, the result's new storages as
    ``output_bytes`` and those that are arguments' as ``alias_bytes``),
    ``hlo`` (the traced counts, per rank) and ``roofline``."""
    t0 = time.perf_counter()
    step, args, _, _, meta = build_step(cfg, shape, mesh)
    arg_b = argument_bytes(shape, args, meta)     # before the step runs
    stats = roofline.analyze(step, *args)
    trace_s = time.perf_counter() - t0
    terms = roofline.roofline_terms(
        stats, model_flops_global=roofline.model_flops(cfg, shape),
        chips=chips,
        analytic_bytes=roofline.analytic_memory_bytes(cfg, shape, meta))
    return dict(
        meta={k: (round(v, 1) if isinstance(v, float) else v)
              for k, v in meta.items()},
        trace_s=round(trace_s, 1),
        memory=dict(
            argument_bytes=arg_b,
            output_bytes=int(stats.output_bytes),
            temp_bytes=int(stats.peak_bytes),
            alias_bytes=int(stats.alias_bytes),
            per_device_total=int(arg_b + stats.peak_bytes),
        ),
        hlo=dict(
            dot_flops_per_dev=stats.dot_flops,
            hbm_bytes_per_dev=stats.hbm_bytes,
            collective_bytes_per_dev=stats.collective_bytes,
            per_collective=stats.per_collective,
            loop_trips=stats.loop_trips,
            op_counts=stats.op_counts,
            op_flops=stats.op_flops,
        ),
        roofline=terms,
    )


def run_pair(arch: str, shape_name: str, multi_pod: bool, outdir: str,
             save: bool = True) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    want = production_shape(multi_pod)
    chips = want.size
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, want.shape)),
           "chips": chips, "status": "SKIP"}
    if not shape_applicable(cfg, shape):
        rec["reason"] = "long_500k needs sub-quadratic attention (DESIGN.md)"
        return _emit(rec, outdir, save)
    try:
        rec.update(status="OK", **trace_pair(cfg, shape,
                                             fake_world(multi_pod), chips))
    except Exception as e:  # record the failure, don't crash the sweep
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return _emit(rec, outdir, save)


def _emit(rec: dict, outdir: str, save: bool) -> dict:
    line = (f"{rec['arch']:20s} {rec['shape']:12s} mesh={rec['mesh']:8s} "
            f"{rec['status']}")
    if rec["status"] == "OK":
        r = rec["roofline"]
        line += (f" trace={rec['trace_s']:.1f}s"
                 f" mem/dev={rec['memory']['per_device_total']/2**30:.2f}GiB"
                 f" compute={r['compute_s']*1e3:.2f}ms"
                 f" memory={r['memory_s']*1e3:.2f}ms"
                 f" coll={r['collective_s']*1e3:.2f}ms"
                 f" dom={r['dominant']}"
                 f" useful={r['useful_flops_ratio']:.2f}")
    elif rec["status"] == "FAIL":
        line += " " + rec["error"][:160]
    print(line, flush=True)
    if save:
        os.makedirs(outdir, exist_ok=True)
        fn = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
        with open(os.path.join(outdir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, help="one shape (default all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.perf_counter()
    recs = [run_pair(a, s, mp, args.out)
            for mp in meshes for a in archs for s in shapes]
    print(f"{len(recs)} pairs in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{sum(r['status'] == st for r in recs)} {st}"
                      for st in ("OK", "SKIP", "FAIL")), flush=True)
    return recs


if __name__ == "__main__":
    main()
