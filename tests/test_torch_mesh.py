"""The port's serving mesh (``launch/mesh.py``) and serving layout
(``distributed/sharding.py``, ``models/api._SECTIONS``) against the
reference's.

``parse_mesh`` gives the reference's values and errors on the same
strings; ``make_serve_mesh`` lays out (data, model) entries of
``torch.device`` (repeats allowed), with processes in contiguous blocks of
the data axis, and raises with the count when CUDA devices are missing;
the sharded engine refuses a mesh row that mixes device types, or names
CUDA devices the process lacks or cards that are not peers;
``process_replicas`` gives the reference's map for a one-process mesh and
splits the replicas contiguously over processes; the slot axis of every
pool leaf (``_SECTIONS``: axis 0 for head and tail leaves, 1 for the
stacked blocks) is the axis the reference's ``serve_pool_specs`` shards
over 'data', leaf for leaf, for every reduced config's pool, and splitting
a pool of data * spr slots along it gives each replica's own
``init_caches(spr)`` pool, which joins back to the whole bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.distributed.sharding import process_replicas as j_process_replicas
from repro.distributed.sharding import serve_pool_specs as j_serve_pool_specs
from repro.launch import mesh as jmesh
from repro.models import build_model as j_build
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.distributed.sharding import process_replicas
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.models.api import _SECTIONS
from repro_torch.serve import ShardedServeEngine

torch.set_num_threads(1)


@pytest.mark.parametrize("spec", ["4x2", "2X2", "1x8", "3x1", "0x2", "2", "ax2", "2x-1",
                                  "2x2x2"])
def test_parse_mesh_matches_the_reference(spec):
    try:
        want = jmesh.parse_mesh(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.parse_mesh(spec)
        assert str(got.value) == str(e)
        return
    assert tmesh.parse_mesh(spec) == want


@pytest.mark.parametrize("devices", [
    ["cpu", "meta"],
    ["cuda:0", "cuda:1"],
    ["cpu", "cpu", "cpu", "meta"],
    ["cuda:0", "cuda:1", "cuda:2", "cuda:3"],
    ["cuda:0", "cuda:0", "cuda:0", "cuda:1"],
])
def test_a_mesh_row_over_distinct_devices_is_refused(devices):
    """A row that mixes device types is refused before anything is built,
    naming the row and the types.  A row over distinct cards builds where
    the process has the cards and they are peers; else it is refused
    before anything is built, naming the CUDA devices it lacks or the pair
    without peer access (nothing is staged through the host)."""
    m = tmesh.make_serve_mesh(len(devices) // 2, 2, devices)
    cfg = t_reduced("stablelm-1.6b")
    bad = next(r for r in range(m.devices.shape[0]) if len(set(m.devices[r])) > 1)
    row = list(m.devices[bad])
    if len({d.type for d in row}) > 1:
        with pytest.raises(ValueError, match=f"mesh row {bad} mixes device types "
                                             f"\\['cpu', 'meta'\\]"):
            ShardedServeEngine(cfg, None, mesh=m)
        return
    have, need = torch.cuda.device_count(), max(d.index for d in m.devices.flat) + 1
    if have < need:
        with pytest.raises(RuntimeError, match=f"mesh row {bad} .* needs "
                                               f"{max(d.index for d in row) + 1} CUDA "
                                               f"devices, found {have}"):
            ShardedServeEngine(cfg, None, mesh=m)
        return
    peers = all(torch.cuda.can_device_access_peer(a, b) for a in row for b in row if a != b)
    if not peers:
        with pytest.raises(RuntimeError, match=f"mesh row {bad}: .* peer access"):
            ShardedServeEngine(cfg, None, mesh=m)
        return
    eng = ShardedServeEngine(cfg, build_model(cfg, "cpu").init(0), mesh=m,
                             slots_per_replica=1, max_len=32, buckets=(8,))
    assert [rep.row.devices for rep in eng.replicas] == [list(r) for r in m.devices]


def test_make_serve_mesh_over_cpu_entries():
    m = tmesh.make_serve_mesh(4, 2, ["cpu"] * 8)
    assert m.shape == {"data": 4, "model": 2}
    # the axes are the class's, never a per-mesh setting
    assert m.axis_names == tmesh.Mesh.axis_names == ("data", "model")
    assert [f.name for f in dataclasses.fields(m)] == ["devices", "processes"]
    assert m.devices.shape == (4, 2) and all(d == torch.device("cpu") for d in m.devices.flat)
    assert (m.processes == 0).all()
    two = tmesh.make_serve_mesh(4, 2, ["cpu"] * 8, processes=2)
    assert two.processes.tolist() == [[0, 0], [0, 0], [1, 1], [1, 1]]
    with pytest.raises(ValueError, match="needs 8 device entries, got 7"):
        tmesh.make_serve_mesh(4, 2, ["cpu"] * 7)
    with pytest.raises(ValueError, match="must divide over 2 processes"):
        tmesh.make_serve_mesh(3, 1, ["cpu"] * 3, processes=2)


def test_make_serve_mesh_raises_without_the_cuda_devices():
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"needs {have + 1} CUDA devices, found {have}"):
        tmesh.make_serve_mesh(have + 1, 1)
    with pytest.raises(RuntimeError, match=f"in each of 2 processes, found {have}"):
        tmesh.make_serve_mesh(2 * (have + 1), 1, processes=2)


def test_process_replicas():
    assert process_replicas(tmesh.make_serve_mesh(4, 2, ["cpu"] * 8)) == {0: [0, 1, 2, 3]}
    assert process_replicas(tmesh.make_serve_mesh(4, 2, ["cpu"] * 8, processes=2)) == {
        0: [0, 1], 1: [2, 3]}
    assert process_replicas(tmesh.make_serve_mesh(4, 1, ["cpu"] * 4, processes=4)) == {
        0: [0], 1: [1], 2: [2], 3: [3]}
    # the reference's map of a one-process mesh (its one host device)
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    assert process_replicas(tmesh.make_serve_mesh(1, 1, ["cpu"])) == j_process_replicas(jm)


def _axis(spec) -> int:
    return list(spec).index("data")


def _slot_axes(caches) -> dict:
    """The slot axis of each leaf of a cache-shaped tree, in its shape."""
    return {sec: tuple({k: ba for k in d} for d in caches[sec]) for sec, ba in _SECTIONS}


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_serve_pool_specs_match_the_reference(arch):
    """The slot axis of every leaf of the reduced config's pool is where
    the reference shards over 'data'."""
    mem = 8 if t_reduced(arch).family == "encdec" else 0
    tc = build_model(t_reduced(arch), "cpu").init_caches(4, 32, mem)
    jc = j_build(j_reduced(arch)).init_caches(4, 32, mem)
    want = j_serve_pool_specs(jc)
    got = _slot_axes(tc)
    for sec in ("head", "tail", "blocks"):
        assert len(got[sec]) == len(want[sec]), sec
        for g, w in zip(got[sec], want[sec]):
            assert g == {k: _axis(v) for k, v in w.items()}, (sec, g, w)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-2.7b", "deepseek-v2-236b"])
def test_pool_splits_per_replica_and_joins_back(arch):
    """A pool of data * spr slots split along the slot axes is each
    replica's own ``init_caches(spr)`` pool (shapes and dtypes), and the
    replicas' pools joined along them are the pool bit for bit."""
    cfg = t_reduced(arch)
    b = build_model(cfg, "cpu")
    D, spr = 4, 2
    pool = b.init_caches(D * spr, 32)
    gen = torch.Generator().manual_seed(0)
    for sec in ("head", "tail", "blocks"):        # distinct contents in every slot
        for d in pool[sec]:
            for k, v in d.items():
                d[k] = (torch.randint(-100, 100, v.shape, generator=gen).to(v.dtype)
                        if not v.is_floating_point()
                        else torch.randn(v.shape, generator=gen).to(v.dtype))
    specs = _slot_axes(pool)
    one = b.init_caches(spr, 32)
    parts = [{sec: tuple({k: v.narrow(specs[sec][i][k], r * spr, spr)
                          for k, v in d.items()} for i, d in enumerate(pool[sec]))
              for sec in pool} for r in range(D)]
    for part in parts:
        for sec in pool:
            for d, o in zip(part[sec], one[sec]):
                assert {k: (v.shape, v.dtype) for k, v in d.items()} == {
                    k: (v.shape, v.dtype) for k, v in o.items()}
    for sec in pool:
        for i, d in enumerate(pool[sec]):
            for k, v in d.items():
                joined = torch.cat([p[sec][i][k] for p in parts], specs[sec][i][k])
                assert torch.equal(joined, v), (sec, i, k)
