# The port's device mesh (parallel/mesh.py: the axes, shard_pytree's
# blocks) and sequence-parallel attention (ring, Ulysses, sp decode)
# against the JAX package's, on the CPU.  JAX runs on its virtual 8-device CPU mesh (tests/conftest.py) with
# its Pallas kernels in interpret mode, as tests/test_parallel.py runs
# them; the port's mesh names the CPU eight times (set_default_devices),
# its counterpart of the forced host device count, and its kernels take
# their plain versions on CPU tensors.  The same seeded numpy inputs go
# into both.
#
# Tolerances (f32 throughout): outputs atol/rtol 1e-5 against the JAX
# function -- both merge the same per-hop partials by logsumexp, in
# another summation order inside each hop (the Pallas kernel's 8-wide
# blocks against one f32 product); gradients atol/rtol 1e-5 likewise;
# against the plain attention oracle atol/rtol 2e-3, the JAX tests'
# own bound.

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.parallel import attention as jax_attention
from aiko_services_tpu.parallel import create_mesh as jax_create_mesh
from aiko_services_tpu_torch.parallel import attention as torch_attention
from aiko_services_tpu_torch.parallel import mesh as torch_mesh
from aiko_services_tpu_torch.parallel.mesh import PartitionSpec as P

TOL = dict(atol=1e-5, rtol=1e-5)
ORACLE_TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.fixture(autouse=True)
def eight_cpus():
    """The port's device list: the CPU, eight times."""
    torch_mesh.set_default_devices(["cpu"] * 8)
    try:
        yield
    finally:
        torch_mesh.set_default_devices(None)


def _qkv(batch=1, heads=4, seq=64, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    shape = (batch, heads, seq, dim)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]


def _torch(*arrays, grad=False):
    return [torch.from_numpy(array.copy()).requires_grad_(grad)
            for array in arrays]


# -- the mesh ----------------------------------------------------------------

class TestMesh:
    def test_create_mesh_fill_axis(self):
        mesh = torch_mesh.create_mesh({"data": 1, "seq": -1})
        assert mesh.shape["seq"] == 8
        assert mesh.shape["data"] == 1
        assert mesh.axis_devices("seq") == [torch.device("cpu")] * 8

    def test_default_mesh_is_one_data_axis(self):
        mesh = torch_mesh.create_mesh(devices=["cpu"])
        assert dict(mesh.shape) == {"data": 1}

    def test_axis_order_canonical(self):
        mesh = torch_mesh.create_mesh({"model": 1, "data": 1, "seq": 2},
                                      devices=["cpu"] * 2)
        assert tuple(mesh.axis_names) == ("data", "seq", "model")

    def test_get_mesh_cached(self):
        assert (torch_mesh.get_mesh({"seq": -1})
                is torch_mesh.get_mesh({"seq": -1}))
        assert (torch_mesh.get_mesh({"seq": -1})
                is not torch_mesh.get_mesh({"seq": -1}, ["cpu"] * 4))

    @pytest.mark.parametrize("axes, message", [
        ({"seq": -1, "data": 3}, "not divisible by fixed axes"),
        ({"seq": -1, "data": -1}, "Only one mesh axis may be -1"),
        ({"seq": 16}, "need 16 devices, have 8"),
    ])
    def test_bad_axes_keep_the_jax_messages(self, axes, message):
        with pytest.raises(ValueError, match=message):
            torch_mesh.create_mesh(axes)

    def test_named_sharding_spec_coercion(self):
        mesh = torch_mesh.get_mesh({"seq": -1})
        sharding = torch_mesh.named_sharding(mesh, ["seq", None])
        assert sharding.spec == P("seq", None)
        assert torch_mesh.partition_spec("seq") == P("seq")
        assert torch_mesh.partition_spec(None) == P()
        assert torch_mesh.partition_spec([["data", "seq"], None]) == P(
            ("data", "seq"), None)

    @pytest.mark.parametrize("axes", [{"model": 2}, {"data": 2},
                                      {"seq": 2, "model": 2},
                                      {"fsdp": 2}, {"expert": 2}])
    def test_parameter_sharding_axes_cut_as_jax(self, axes):
        """Every parameter-sharding axis builds a mesh, and a leaf cut
        over it (dimension 0 by the first axis, dimension 1 by the last)
        has JAX's shard shapes and values, each block on its device."""
        count = int(np.prod(list(axes.values())))
        names = list(axes)
        spec = (names[0], names[-1] if len(names) > 1 else None)
        mesh = torch_mesh.create_mesh(axes, devices=["cpu"] * count)
        jax_mesh = jax_create_mesh(axes, devices=jax.devices()[:count])
        array = np.arange(64, dtype=np.float32).reshape(8, 8)
        placed = torch_mesh.shard_pytree(torch.from_numpy(array), mesh,
                                         P(*spec))
        expected = jax.device_put(array, jax.sharding.NamedSharding(
            jax_mesh, jax.sharding.PartitionSpec(*spec)))
        assert isinstance(placed, torch_mesh.Sharded)
        blocks = {tuple(part.indices(8)[:2] for part in shard.index):
                  np.asarray(shard.data)
                  for shard in expected.addressable_shards}
        for position, block in np.ndenumerate(placed.shards):
            assert block.device == mesh.devices[position]
            index = tuple((start * size, (start + 1) * size)
                          for start, size in zip(placed.block(position),
                                                 block.shape))
            np.testing.assert_array_equal(block.numpy(), blocks[index])
        np.testing.assert_array_equal(torch_mesh.unshard(placed).numpy(),
                                      array)

    def test_filter_specs(self):
        mesh = torch_mesh.create_mesh({"data": 1, "seq": 4},
                                      devices=["cpu"] * 4)
        specs = {"k": P(None, "data", "model", "seq", None),
                 "w": ["fsdp", "model"], "b": None,
                 "pair": (P(("data", "model"), None), P("expert"))}
        assert torch_mesh.filter_specs(specs, mesh) == {
            "k": P(None, "data", None, "seq", None), "w": P(None, None),
            "b": P(), "pair": (P(("data",), None), P(None))}

    def test_ambient_mesh_is_thread_local(self):
        meshes = {name: torch_mesh.create_mesh({"seq": size},
                                              devices=["cpu"] * size)
                  for name, size in (("a", 2), ("b", 4))}
        seen, barrier = {}, threading.Barrier(2)

        def run(name):
            with torch_mesh.use_mesh(meshes[name]):
                barrier.wait(timeout=10)   # both scopes open at once
                seen[name] = torch_mesh.ambient_mesh()
                barrier.wait(timeout=10)
            seen[name + "_after"] = torch_mesh.ambient_mesh()

        threads = [threading.Thread(target=run, args=(name,))
                   for name in meshes]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=30)
            assert not thread.is_alive()
        assert seen["a"] is meshes["a"] and seen["b"] is meshes["b"]
        assert seen["a_after"] is None and seen["b_after"] is None
        assert torch_mesh.ambient_mesh() is None


class TestShardPytreeSemantics:
    """shard_pytree's spec trees, as the JAX package's tests hold them,
    over the seq axis: prefix broadcast, partial trees (missing leaves
    replicate), per-item structural lists, namedtuples.  tree_shardings
    gives the sharding shard_pytree places each leaf with."""

    def _mesh(self):
        return torch_mesh.create_mesh({"data": 1, "seq": 4},
                                      devices=["cpu"] * 4)

    def _shard(self, tree, specs):
        """(placed tree, tree of each leaf's sharding)."""
        mesh = self._mesh()
        return (torch_mesh.shard_pytree(tree, mesh, specs),
                torch_mesh.tree_shardings(tree, mesh, specs))

    def test_single_spec_replicates_every_leaf(self):
        tree = {"w": torch.zeros(8, 4), "b": np.zeros(4, np.float32)}
        out, shardings = self._shard(tree, None)
        assert shardings["w"].is_fully_replicated
        assert shardings["b"].is_fully_replicated
        assert out["w"] is tree["w"]   # already on the home device
        assert isinstance(out["b"], torch.Tensor)

    def test_axis_list_broadcasts_over_collection(self):
        tree = {"a": [torch.zeros(4, 8), torch.zeros(4, 8)]}
        out, shardings = self._shard(tree, {"a": ["seq", None]})
        assert len(out["a"]) == 2
        for sharding in shardings["a"]:
            assert sharding.spec == P("seq", None)
            assert not sharding.is_fully_replicated

    def test_partial_tree_missing_leaves_replicate(self):
        tree = {"w": torch.zeros(4, 8), "b": torch.zeros(8)}
        _, shardings = self._shard(tree, {"w": P(None, "seq")})
        assert shardings["w"].spec == P(None, "seq")
        assert shardings["b"].is_fully_replicated

    def test_per_item_structural_list(self):
        tree = {"stages": [{"w": torch.zeros(4, 8)},
                           {"w": torch.zeros(8, 4)}]}
        _, shardings = self._shard(tree, {"stages": [
            {"w": P("seq", None)}, {"w": P(None, "seq")}]})
        assert shardings["stages"][0]["w"].spec == P("seq", None)
        assert shardings["stages"][1]["w"].spec == P(None, "seq")

    def test_spec_broadcast_through_subtree(self):
        tree = {"block": {"w1": torch.zeros(4, 8), "w2": torch.zeros(4, 8)}}
        _, shardings = self._shard(tree, {"block": P("seq", None)})
        assert shardings["block"]["w1"].spec == P("seq", None)
        assert shardings["block"]["w2"].spec == P("seq", None)

    def test_namedtuple_rebuilt_with_positional_fields(self):
        import collections
        State = collections.namedtuple("State", ["mu", "nu"])
        tree = {"opt": State(mu=torch.zeros(4, 8), nu=torch.zeros(4, 8))}
        out, shardings = self._shard(tree, {"opt": P("seq", None)})
        assert isinstance(out["opt"], State)
        assert shardings["opt"].mu.spec == P("seq", None)

    def test_indivisible_dimension_raises(self):
        with pytest.raises(ValueError, match="not divisible"):
            torch_mesh.shard_pytree(torch.zeros(6, 2), self._mesh(),
                                    P("seq", None))


# -- attention against the JAX package ----------------------------------------

def _meshes(n: int):
    return (jax_create_mesh({"seq": n}, devices=jax.devices()[:n]),
            torch_mesh.create_mesh({"seq": n}, devices=["cpu"] * n))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(n, causal):
    jax_mesh, mesh = _meshes(n)
    q, k, v = _qkv(batch=2, heads=2, seq=64, dim=8, seed=n)
    expected = np.asarray(jax_attention.ring_attention(
        q, k, v, jax_mesh, causal=causal))
    actual = torch_attention.ring_attention(*_torch(q, k, v), mesh,
                                            causal=causal)
    np.testing.assert_allclose(actual.numpy(), expected, **TOL)
    oracle = torch_attention.attention_reference(*_torch(q, k, v),
                                                 causal=causal)
    np.testing.assert_allclose(actual.numpy(), oracle.numpy(), **ORACLE_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradients_match_jax(causal):
    """JAX test_ring_grad_parity's loss, through both packages' rings."""
    jax_mesh, mesh = _meshes(4)
    q, k, v = _qkv(batch=1, heads=2, seq=64, dim=8, seed=11)

    def jax_loss(q, k, v):
        out = jax_attention.ring_attention(q, k, v, jax_mesh, causal=causal)
        return jnp.sum(out * jnp.cos(out.astype(jnp.float32)))

    expected = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    inputs = _torch(q, k, v, grad=True)
    out = torch_attention.ring_attention(*inputs, mesh, causal=causal)
    grads = torch.autograd.grad(torch.sum(out * torch.cos(out)), inputs)
    for actual, wanted, name in zip(grads, expected, ("dq", "dk", "dv")):
        np.testing.assert_allclose(actual.numpy(), np.asarray(wanted),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("causal, hops", [(True, 36), (False, 64)])
def test_executed_hops(causal, hops):
    """Device i runs i + 1 of the 8 hops under causal masking: 36, not
    64 -- the same count as the JAX package's callback."""
    jax_mesh, mesh = _meshes(8)
    q, k, v = _qkv(batch=1, heads=2, seq=64, dim=8)
    executed = {"jax": [], "torch": []}
    jax_attention._RING_HOP_CALLBACK = lambda step: executed["jax"].append(
        int(step))
    torch_attention._RING_HOP_CALLBACK = executed["torch"].append
    try:
        jax.block_until_ready(jax_attention.ring_attention(
            q, k, v, jax_mesh, causal=causal))
        torch_attention.ring_attention(*_torch(q, k, v), mesh,
                                       causal=causal)
    finally:
        jax_attention._RING_HOP_CALLBACK = None
        torch_attention._RING_HOP_CALLBACK = None
    assert len(executed["torch"]) == hops
    assert sorted(executed["torch"]) == sorted(executed["jax"])


def test_ring_runs_on_the_ambient_mesh_and_checks_divisibility():
    _, mesh = _meshes(4)
    q, k, v = _torch(*_qkv(seq=64))
    with pytest.raises(ValueError, match="needs a mesh"):
        torch_attention.ring_attention(q, k, v)
    with torch_mesh.use_mesh(mesh):
        ambient = torch_attention.ring_attention(q, k, v)
    np.testing.assert_array_equal(
        ambient.numpy(), torch_attention.ring_attention(q, k, v, mesh).numpy())
    q, k, v = _torch(*_qkv(seq=66))
    with pytest.raises(ValueError, match="divisible by mesh axis"):
        torch_attention.ring_attention(q, k, v, mesh)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(causal):
    jax_mesh, mesh = _meshes(8)
    q, k, v = _qkv(batch=1, heads=8, seq=64, dim=8, seed=3)
    expected = np.asarray(jax_attention.ulysses_attention(
        q, k, v, jax_mesh, causal=causal))
    actual = torch_attention.ulysses_attention(*_torch(q, k, v), mesh,
                                               causal=causal)
    np.testing.assert_allclose(actual.numpy(), expected, **TOL)


def test_ulysses_gradients_match_jax():
    jax_mesh, mesh = _meshes(4)
    q, k, v = _qkv(batch=1, heads=8, seq=32, dim=8, seed=4)

    def jax_loss(q, k, v):
        out = jax_attention.ulysses_attention(q, k, v, jax_mesh,
                                              causal=True)
        return jnp.sum(out * jnp.cos(out))

    expected = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    inputs = _torch(q, k, v, grad=True)
    out = torch_attention.ulysses_attention(*inputs, mesh, causal=True)
    grads = torch.autograd.grad(torch.sum(out * torch.cos(out)), inputs)
    for actual, wanted in zip(grads, expected):
        np.testing.assert_allclose(actual.numpy(), np.asarray(wanted), **TOL)


def test_ulysses_heads_divisibility_message_matches_jax():
    jax_mesh, mesh = _meshes(8)
    q, k, v = _qkv(batch=1, heads=4, seq=64, dim=8)
    with pytest.raises(ValueError) as jax_error:
        jax_attention.ulysses_attention(q, k, v, jax_mesh)
    with pytest.raises(ValueError) as torch_error:
        torch_attention.ulysses_attention(*_torch(q, k, v), mesh)
    assert str(torch_error.value) == str(jax_error.value)
    assert "heads (4) must be divisible" in str(torch_error.value)


@pytest.mark.parametrize("q_len, heads, kv_heads, pos", [
    (1, 2, 2, 37), (4, 2, 2, 37), (1, 4, 2, 21), (4, 8, 2, 50)])
def test_sp_decode_matches_jax(q_len, heads, kv_heads, pos):
    """q_len 1 and 4; GQA (H > Hkv) contracts grouped heads against the
    un-expanded cache shard."""
    jax_mesh, mesh = _meshes(8)
    rng = np.random.default_rng(pos)
    k, v = (rng.standard_normal((2, kv_heads, 64, 8), dtype=np.float32)
            for _ in range(2))
    q = rng.standard_normal((2, heads, q_len, 8), dtype=np.float32)
    expected = np.asarray(jax_attention.sp_decode_attention(
        q, k, v, pos, mesh=jax_mesh))
    q_t, k_t, v_t = _torch(q, k, v)
    actual = torch_attention.sp_decode_attention(q_t, k_t, v_t, pos,
                                                 mesh=mesh)
    np.testing.assert_allclose(actual.numpy(), expected, **TOL)
    repeats = heads // kv_heads
    oracle = torch_attention.attention_reference(
        q_t, k_t.repeat_interleave(repeats, 1)[:, :, :pos + q_len],
        v_t.repeat_interleave(repeats, 1)[:, :, :pos + q_len], causal=True)
    np.testing.assert_allclose(actual.numpy(), oracle.numpy(), **ORACLE_TOL)


def test_sp_decode_composes_with_tp():
    """JAX test_sp_decode_composes_with_tp: sp decode on data 2 x seq 2 x
    model 2 (the batch on data, the heads on model where the mesh has
    them), against JAX's and the plain attention over the written
    positions."""
    axes = {"data": 2, "seq": 2, "model": 2}
    jax_mesh = jax_create_mesh(axes)
    mesh = torch_mesh.create_mesh(axes)
    _, k, v = _qkv(batch=2, heads=2, seq=32, dim=8, seed=6)
    q = np.random.default_rng(2).standard_normal((2, 2, 1, 8),
                                                 dtype=np.float32)
    expected = np.asarray(jax_attention.sp_decode_attention(
        q, k, v, 19, mesh=jax_mesh))
    q_t, k_t, v_t = _torch(q, k, v)
    actual = torch_attention.sp_decode_attention(q_t, k_t, v_t, 19,
                                                 mesh=mesh)
    np.testing.assert_allclose(actual.numpy(), expected, **TOL)
    oracle = torch_attention.attention_reference(
        q_t, k_t[:, :, :20], v_t[:, :, :20], causal=True)
    np.testing.assert_allclose(actual.numpy(), oracle.numpy(), **ORACLE_TOL)


class TestShardPytreeOnParameterAxes:
    """JAX TestShardPytreeSemantics on its data 2 x model 4 mesh: an axis
    list broadcasts over a collection, a partial tree replicates the
    leaves it leaves out; the cut leaves are Sharded."""

    def _mesh(self):
        return torch_mesh.create_mesh({"data": 2, "model": 4})

    def test_axis_list_broadcasts_over_collection(self):
        tree = {"a": [torch.zeros(4, 8), torch.zeros(4, 8)]}
        out = torch_mesh.shard_pytree(tree, self._mesh(),
                                      {"a": ["data", None]})
        for leaf in out["a"]:
            assert leaf.sharding.spec == P("data", None)
            assert {tuple(block.shape) for block in leaf.unique()} == {
                (2, 8)}

    def test_partial_tree_missing_leaves_replicate(self):
        tree = {"w": torch.zeros(4, 8), "b": torch.zeros(8)}
        out = torch_mesh.shard_pytree(tree, self._mesh(),
                                      {"w": P(None, "model")})
        assert out["w"].sharding.spec == P(None, "model")
        assert not isinstance(out["b"], torch_mesh.Sharded)
        assert torch_mesh.tree_shardings(tree, self._mesh(), {
            "w": P(None, "model")})["b"].is_fully_replicated
