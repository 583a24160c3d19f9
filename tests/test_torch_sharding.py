"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's ``PartitionSpec``s, leaf by leaf, with no devices: all ten
archs at PUBLISHED width on the 16x16, 2x16x16, 4x4 and 1x1 meshes, FSDP
off and on, expert parallelism for the two MoE archs, every input shape's
batch, the decode caches (sequence-sharded for the three long-context
archs) and the per-device bytes.

The reference reads only ``mesh.axis_names`` and ``mesh.devices.shape``,
so a stand-in carries them; its trees are ``jax.eval_shape`` shape trees.
The port's trees are fake tensors (``FakeTensorMode``): its own per-layer
parameters, and the reference's layout as meta tensors.  Nothing at full
width is allocated on either side (qwen2-vl-72b has 72B parameters).  The
mesh builders of ``repro_torch.launch.mesh`` and ``shape_applicable`` are
here too."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.configs import (INPUT_SHAPES as J_SHAPES,  # noqa: E402
                           get_config as j_get_config,
                           shape_applicable as j_shape_applicable)
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch.specs import input_specs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ARCHS = configs.ARCH_IDS
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "4x4": (("data", "model"), (4, 4)),
          "1x1": (("data", "model"), (1, 1))}
LONG = [a for a in ARCHS if configs.get_config(a).supports_long_context]
MAX_SEQ = 4096
_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32,
       "int32": torch.int32, "uint32": torch.int32}


def _meshes(name):
    axes, shape = MESHES[name]
    return (types.SimpleNamespace(axis_names=axes, devices=np.empty(shape)),
            mesh_lib.MeshShape(axes, shape))


def _norm(spec, ndim):
    """A spec as a tuple of ndim entries (a reference P may be shorter)."""
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _flat(tree, is_leaf=None):
    """{path: leaf} of a jax tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        out[jsh._path_str(path)] = leaf
    return out


def _is_p(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _meta(tree):
    """A jax shape tree -> the same tree of meta tensors."""
    return jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=_DT[str(s.dtype)], device="meta"), tree)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(
        lambda k: JModel(j_get_config(arch)).init_params(k, max_seq=MAX_SEQ),
        jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return Model(configs.get_config(arch)).init_params(
            seed=0, device="cpu", max_seq=MAX_SEQ)


def _port_paths(cfg, tree):
    """{(reference path, layer or None): leaf} of the port's param tree."""
    out = {}

    def walk(node, path, layer):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k, layer)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                if path == "blocks":
                    walk(v, f"blocks/{sh._slot(cfg, i)}", i)
                else:                                  # encoder/blocks
                    walk(v, path, i)
        else:
            out[(path, layer)] = node
    walk(tree, "", None)
    return out


def _param_cases():
    cases = []
    for arch in ARCHS:
        for mesh in MESHES:
            for fsdp in (False, True):
                cases.append((arch, mesh, fsdp, False))
            if configs.get_config(arch).moe is not None:
                cases.append((arch, mesh, False, True))
    return cases


@pytest.mark.parametrize("arch,mesh,fsdp,moe_ep", _param_cases(),
                         ids=lambda v: str(v))
def test_param_specs_match_reference(arch, mesh, fsdp, moe_ep):
    """Every leaf of the port's own parameters (per layer) and of the
    reference's layout (stacked, as meta tensors) gets the reference's
    spec (without the cycle dim for a port layer), and the per-device
    bytes and DTensor placements agree."""
    cfg = configs.get_config(arch)
    jcfg = j_get_config(arch)
    jmesh, pmesh = _meshes(mesh)
    ref_tree = _ref_params(arch)
    ref = _flat(jsh.param_specs(jcfg, ref_tree, jmesh, fsdp=fsdp,
                                moe_ep=moe_ep), _is_p)
    shapes = _flat(ref_tree)
    # the reference's layout, as meta tensors
    meta = _meta(ref_tree)
    ours = sh.param_specs(cfg, meta, pmesh, fsdp=fsdp, moe_ep=moe_ep)
    flat_ours = _flat(jax.tree.map(lambda s: tuple(s), ours,
                                   is_leaf=lambda x: isinstance(x, sh.Spec)),
                      lambda x: isinstance(x, tuple))
    assert set(flat_ours) == set(ref)
    for path, spec in ref.items():
        nd = len(shapes[path].shape)
        assert flat_ours[path] == _norm(spec, nd), path
        assert len(flat_ours[path]) == nd, path
    assert sh.local_bytes(meta, ours, pmesh) == \
        jsh.local_bytes(ref_tree, jsh.param_specs(jcfg, ref_tree, jmesh,
                                                  fsdp=fsdp, moe_ep=moe_ep),
                        jmesh)
    # the port's own per-layer tree: the reference's spec less the cycle
    port = _port_params(arch)
    pspecs = sh.param_specs(cfg, port, pmesh, fsdp=fsdp, moe_ep=moe_ep)
    leaves = _port_paths(cfg, port)
    specs = _port_paths(cfg, pspecs)
    assert set(leaves) == set(specs)
    seen = set()
    for (path, layer), leaf in leaves.items():
        nd = len(leaf.shape)
        want = _norm(ref[path], nd + (layer is not None))
        want = want[1:] if layer is not None else want
        assert tuple(specs[(path, layer)]) == want, (path, layer)
        assert tuple(shapes[path].shape)[-nd:] == tuple(leaf.shape), path
        seen.add(path)
    assert seen == set(ref)
    # placements: Shard(dim) on each named axis, Replicate elsewhere
    from torch.distributed.tensor import Replicate, Shard
    for spec in (s for s in sh.leaves(pspecs)):
        pl = sh.placements(spec, pmesh)
        for ax, p in zip(pmesh.axis_names, pl):
            dims = [d for d, e in enumerate(spec)
                    if e == ax or (isinstance(e, tuple) and ax in e)]
            assert p == (Shard(dims[0]) if dims else Replicate())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_logits_and_token_specs_match_reference(arch, mesh):
    cfg, jcfg = configs.get_config(arch), j_get_config(arch)
    jmesh, pmesh = _meshes(mesh)
    for name, shape in J_SHAPES.items():
        batch = input_specs(jcfg, shape)
        ref = jsh.batch_specs(jcfg, batch, jmesh)
        ours = sh.batch_specs(cfg, _meta(batch), pmesh)
        assert set(ours) == set(ref)
        for k in ref:
            assert tuple(ours[k]) == _norm(ref[k], len(batch[k].shape)), \
                (name, k)
        B = shape.global_batch
        assert tuple(sh.logits_spec(cfg, pmesh, B)) == \
            tuple(jsh.logits_spec(jcfg, jmesh, B))
        for mrope in (False, True):
            assert tuple(sh.token_spec(pmesh, B, mrope)) == \
                tuple(jsh.token_spec(jmesh, B, mrope))
        assert sh.batch_axes(pmesh, B) == jsh.batch_axes(jmesh, B)


def _cache_cases():
    out = [(a, m, "decode_32k", False) for a in ARCHS for m in MESHES]
    out += [(a, m, "long_500k", True) for a in LONG for m in MESHES]
    return out


@pytest.mark.parametrize("arch,mesh,shape,shard_seq", _cache_cases(),
                         ids=lambda v: str(v))
def test_cache_specs_match_reference(arch, mesh, shape, shard_seq):
    cfg, jcfg = configs.get_config(arch), j_get_config(arch)
    jmesh, pmesh = _meshes(mesh)
    s = J_SHAPES[shape]
    cache = jax.eval_shape(lambda: JModel(jcfg).init_cache(
        s.global_batch, s.seq_len, jnp.bfloat16))
    ref_specs = jsh.cache_specs(jcfg, cache, jmesh, shard_seq=shard_seq)
    ref = _flat(ref_specs, _is_p)
    shapes = _flat(cache)
    meta = _meta(cache)
    ours = sh.cache_specs(cfg, meta, pmesh, shard_seq=shard_seq)
    flat_ours = _flat(jax.tree.map(lambda x: tuple(x), ours,
                                   is_leaf=lambda x: isinstance(x, sh.Spec)),
                      lambda x: isinstance(x, tuple))
    assert set(flat_ours) == set(ref)
    for path, spec in ref.items():
        assert flat_ours[path] == _norm(spec, len(shapes[path].shape)), path
    assert sh.local_bytes(meta, ours, pmesh) == \
        jsh.local_bytes(cache, ref_specs, jmesh)
    if shard_seq and mesh != "1x1":      # a long K/V cache's S is split
        ks = [v for p, v in flat_ours.items() if p.endswith("/k")]
        assert all(k[2] is not None for k in ks)
        assert ks or arch == "xlstm-350m"    # recurrent state only


def test_shape_applicable_matches_reference():
    for arch in ARCHS:
        for name, shape in configs.INPUT_SHAPES.items():
            assert configs.shape_applicable(configs.get_config(arch),
                                            shape) == \
                j_shape_applicable(j_get_config(arch), J_SHAPES[name])
    assert sorted(LONG) == ["gemma2-9b", "hymba-1.5b", "xlstm-350m"]


def test_spec_type_and_placements():
    s = sh.Spec(("data",), None, ("pod", "data"), ())
    assert s == ("data", None, ("pod", "data"), None)
    assert hash(s) == hash(sh.Spec("data", None, ("pod", "data"), None))
    with pytest.raises(TypeError):
        sh.Spec(3)
    with pytest.raises(TypeError):
        s[0] = "model"              # immutable
    from torch.distributed.tensor import Replicate, Shard
    m = mesh_lib.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert sh.placements(sh.Spec(("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.Spec(None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="not in the mesh"):
        sh.placements(sh.Spec("expert"), m)
    with pytest.raises(ValueError, match="two dims"):
        sh.placements(sh.Spec("data", "data"), m)
    # off a mesh maybe_constrain hands back its input, as the reference's
    x = torch.ones(4, 2)
    assert sh.maybe_constrain(x, ("pod", "data"), None) is x


def test_meshes_without_a_group():
    """The production shapes; with no process group (or a world of one) a
    mesh of more ranks raises naming both sizes."""
    assert mesh_lib.production_shape() == mesh_lib.MeshShape(
        ("data", "model"), (16, 16))
    assert mesh_lib.production_shape(True).size == 512
    assert mesh_lib.world_size() == 1
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh_lib.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError):
        mesh_lib.MeshShape(("data",), (2, 2))
