# The port's Checkpointer (utils/checkpoint.py) and the pipeline's
# checkpoint / restore_checkpoint on it, after the JAX package's
# tests/test_checkpoint_dashboard.py (TestCheckpointer,
# TestPipelineCheckpoint) with the port's JaxMLP / ArraySource / ToHost on
# "device": "cpu"; beside it the guarantees the JAX Checkpointer gives
# through orbax (the staging rename, the no_state marker, metadata
# encoded first, a corrupt newest step falling back, pruning), a tree of
# lists, tuples, None, Python scalars and bf16 / int8 / f32 leaves
# restored exactly, and a Sharded element state restored into its
# layout.  Where both packages can take the same tree (f32 arrays and
# JSON metadata), the JAX Checkpointer saves and restores it too and the
# two restores must be equal, bit for bit.

import json
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import save_pytree as jax_save_pytree
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from aiko_services_tpu_torch.parallel import mesh as torch_mesh
from aiko_services_tpu_torch.pipeline import create_pipeline
from aiko_services_tpu_torch.runtime import Process
from aiko_services_tpu_torch.transport import reset_brokers
from aiko_services_tpu_torch.utils.checkpoint import Checkpointer

ELEMENTS = "aiko_services_tpu_torch.elements"


@pytest.fixture(autouse=True)
def clean_brokers():
    reset_brokers()
    yield
    reset_brokers()


def local(class_name):
    return {"local": {"module": ELEMENTS, "class_name": class_name}}


class TestCheckpointer:
    def test_pytree_roundtrip_and_prune(self, tmp_path):
        """JAX test_pytree_roundtrip_and_prune, with the JAX Checkpointer
        on the same values: the same steps kept, equal restores."""
        checkpointer = Checkpointer(tmp_path / "ckpt", max_to_keep=2,
                                    device="cpu")
        reference = JaxCheckpointer(tmp_path / "jax", max_to_keep=2)
        w = np.arange(6.0, dtype=np.float32).reshape(2, 3)
        for step in (1, 2, 3):
            checkpointer.save(step, {"w": torch.from_numpy(w),
                                     "nested": {"b": torch.ones(4)}},
                              metadata={"step": step})
            reference.save(step, {"w": jnp.asarray(w),
                                  "nested": {"b": jnp.ones((4,))}},
                           metadata={"step": step})
        assert checkpointer.steps() == reference.steps() == [2, 3]
        assert checkpointer.latest_step() == 3
        restored, metadata = checkpointer.restore()
        expected, expected_metadata = reference.restore()
        assert metadata == expected_metadata == {"step": 3}
        assert restored["w"].dtype == torch.float32
        np.testing.assert_array_equal(restored["w"].numpy(),
                                      np.asarray(expected["w"]))
        np.testing.assert_array_equal(restored["nested"]["b"].numpy(),
                                      np.asarray(expected["nested"]["b"]))
        assert not list((tmp_path / "ckpt").glob(".staging_*"))

    def test_restore_empty(self, tmp_path):
        tree, metadata = Checkpointer(tmp_path / "none",
                                      device="cpu").restore()
        assert tree is None and metadata == {}
        assert Checkpointer(tmp_path / "none").latest_step() is None

    def test_mixed_tree_roundtrips_exactly(self, tmp_path):
        """Lists, tuples, None, ints, floats, strings and bools, with
        bf16, int8, f32 scale, int64 and numpy leaves: each comes back
        with its type, dtype and bits."""
        generator = torch.Generator().manual_seed(0)
        weight = torch.randn((4, 8), generator=generator)
        codes = torch.randint(-127, 128, (8, 4), generator=generator,
                              dtype=torch.int8)
        tree = {
            "params": {"w": weight.to(torch.bfloat16),
                       "wq": {"w": codes, "w_scale": torch.rand(
                           (1, 4), generator=generator)},
                       "layers": [{"scale": torch.ones(3)},
                                  {"scale": torch.zeros(3)}]},
            "opt_state": ({"count": 7, "mu": [weight, None]}, None),
            "step": 12, "lr": 3e-4, "name": "adamw", "done": False,
            "positions": torch.arange(5), "host": np.arange(4.0),
            "empty": [], "scalar": torch.tensor(2.5),
        }
        checkpointer = Checkpointer(tmp_path, device="cpu")
        checkpointer.save(1, tree, metadata={"kind": "train"})
        restored, metadata = checkpointer.restore(1)
        assert metadata == {"kind": "train"}

        def same(got, want):
            assert type(got) is type(want), (got, want)
            if isinstance(want, torch.Tensor):
                assert got.dtype == want.dtype and got.shape == want.shape
                assert torch.equal(got, want)
            elif isinstance(want, np.ndarray):
                np.testing.assert_array_equal(got, want)
                assert got.dtype == want.dtype
            elif isinstance(want, dict):
                assert list(got) == list(want)
                for key in want:
                    same(got[key], want[key])
            elif isinstance(want, (list, tuple)):
                assert len(got) == len(want)
                for a, b in zip(got, want):
                    same(a, b)
            else:
                assert got == want
        same(restored, tree)

    def test_metadata_only_step_has_no_state_marker(self, tmp_path):
        checkpointer = Checkpointer(tmp_path, device="cpu")
        target = checkpointer.save(4, {"unused": None},
                                   metadata={"streams": {}})
        assert (target / "no_state").exists()
        assert not (target / "state").exists()
        assert checkpointer.restore() == (None, {"streams": {}})

    def test_metadata_is_encoded_before_the_state(self, tmp_path):
        """A non-JSON metadata value fails before anything is written."""
        checkpointer = Checkpointer(tmp_path, device="cpu")
        with pytest.raises(TypeError):
            checkpointer.save(2, {"w": torch.ones(2)},
                              metadata={"bad": np.zeros(2)})
        assert checkpointer.steps() == []
        assert list(tmp_path.iterdir()) == []

    @pytest.mark.parametrize("damage", ["truncate", "lose_state"])
    def test_corrupt_newest_step_falls_back(self, tmp_path, damage):
        checkpointer = Checkpointer(tmp_path, device="cpu")
        checkpointer.save(1, {"w": torch.full((64,), 1.0)}, {"step": 1})
        newest = checkpointer.save(2, {"w": torch.full((64,), 2.0)},
                                   {"step": 2})
        state = newest / "state"
        if damage == "truncate":
            tensors = state / "tensors.safetensors"
            tensors.write_bytes(tensors.read_bytes()[:-100])
        else:
            for path in state.iterdir():
                path.unlink()
            state.rmdir()
        restored, metadata = checkpointer.restore()
        assert metadata == {"step": 1}
        assert torch.equal(restored["w"], torch.full((64,), 1.0))
        with pytest.raises(RuntimeError, match="No readable checkpoint"):
            checkpointer.restore(step=2)

    def test_restore_lands_on_the_asked_device(self, tmp_path):
        checkpointer = Checkpointer(tmp_path, device="meta")
        checkpointer.save(1, {"w": torch.ones(3)})
        restored, _ = checkpointer.restore()
        assert restored["w"].device.type == "meta"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                Checkpointer(tmp_path).restore()


class TestPipelineCheckpoint:
    def _definition(self):
        return {
            "name": "ckpt_pipe",
            "graph": ["(source (mlp (sink)))"],
            "parameters": {"device": "cpu"},
            "elements": [
                {"name": "source", "output": [{"name": "tensor"}],
                 "parameters": {"data_sources": [[4, 16]]},
                 "deploy": local("ArraySource")},
                {"name": "mlp", "input": [{"name": "tensor"}],
                 "output": [{"name": "tensor"}],
                 "parameters": {"features": 16, "hidden": 8},
                 "deploy": local("JaxMLP")},
                {"name": "sink", "input": [{"name": "tensor"}],
                 "output": [{"name": "tensor"}],
                 "deploy": local("ToHost")},
            ],
        }

    def test_element_state_and_cursor_roundtrip(self, tmp_path):
        checkpointer = Checkpointer(tmp_path / "ckpt", device="cpu")
        process = Process(transport_kind="loopback")
        pipeline = create_pipeline(process, self._definition())
        process.run(in_thread=True)
        responses = queue.Queue()
        pipeline.create_stream("s1", queue_response=responses)
        _, _, before = responses.get(timeout=30)
        original_w1 = pipeline.elements["mlp"].state["w1"].clone()
        pipeline.checkpoint(checkpointer, step=7)
        process.terminate()

        # fresh pipeline restores the same weights + stream cursor
        reset_brokers()
        process2 = Process(transport_kind="loopback")
        definition = self._definition()
        definition["elements"][1]["parameters"]["seed"] = 99  # other init
        pipeline2 = create_pipeline(process2, definition)
        process2.run(in_thread=True)
        try:
            metadata = pipeline2.restore_checkpoint(checkpointer)
            assert metadata["pipeline"] == "ckpt_pipe"
            assert set(metadata["streams"]["s1"]) == {
                "frame_id", "parameters", "graph_path"}
            assert torch.equal(pipeline2.elements["mlp"].state["w1"],
                               original_w1)
            assert "s1" in pipeline2.streams
            assert pipeline2.streams["s1"].frame_id >= 1
            # the restored weights compute the same output
            responses2 = queue.Queue()
            pipeline2.create_stream("s2", queue_response=responses2)
            _, _, after = responses2.get(timeout=30)
            np.testing.assert_array_equal(after["tensor"], before["tensor"])
        finally:
            process2.terminate()


def test_sharded_element_state_restores_into_its_layout(tmp_path):
    """LMForward on an fsdp 2 x model 2 element mesh (the CPU named four
    times): its Sharded params are saved whole and restored through
    restore_state into the same layout, and the restored element's
    logits equal the original's bit for bit."""
    config = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=64, max_seq_len=64, dtype="float32")
    weights = tmp_path / "lm.safetensors"
    jax_save_pytree(str(weights), jax_lm.init_params(
        jax_lm.TransformerConfig(**config), jax.random.PRNGKey(3)))
    definition = {
        "name": "sharded_ckpt", "graph": ["(tokens (lm))"],
        "runtime": "torch", "parameters": {"device": "cpu"},
        "elements": [
            {"name": "tokens", "output": [{"name": "tokens"}],
             "parameters": {"data_sources": [[2, 16]], "vocab_size": 128},
             "deploy": local("TokenSource")},
            {"name": "lm", "input": [{"name": "tokens"}],
             "output": [{"name": "logits"}, {"name": "nll"}],
             "parameters": {**config, "weights": str(weights)},
             "sharding": {"axes": {"fsdp": 2, "model": 2}},
             "deploy": local("LMForward")}]}
    checkpointer = Checkpointer(tmp_path / "ckpt", device="cpu")

    def serve(pipeline):
        responses = queue.Queue()
        pipeline.create_stream(f"s{len(pipeline.streams)}",
                               queue_response=responses)
        return responses.get(timeout=120)[2]

    torch_mesh.set_default_devices(["cpu"] * 4)
    processes = []
    try:
        process = Process(transport_kind="loopback")
        processes.append(process)
        pipeline = create_pipeline(process, definition)
        process.run(in_thread=True)
        before = serve(pipeline)
        state = pipeline.elements["lm"].state
        wq = state["layers"]["wq"]["w"]
        assert isinstance(wq, torch_mesh.Sharded)
        layout = torch_mesh.leaf_layout(wq, wq.mesh)
        target = pipeline.checkpoint(checkpointer, step=1)
        stored = json.loads((target / "state" / "tree.json").read_text())
        assert "lm" in dict(stored["dict"])
        process.terminate()
        processes.clear()
        reset_brokers()

        fresh = dict(definition, elements=[
            definition["elements"][0],
            dict(definition["elements"][1], parameters={
                **config, "seed": 42})])  # a random init, then restored
        process = Process(transport_kind="loopback")
        processes.append(process)
        pipeline = create_pipeline(process, fresh)
        process.run(in_thread=True)
        pipeline.restore_checkpoint(checkpointer)
        restored = pipeline.elements["lm"].state["layers"]["wq"]["w"]
        assert isinstance(restored, torch_mesh.Sharded)
        assert torch_mesh.leaf_layout(restored, restored.mesh) == layout
        assert torch.equal(torch_mesh.unshard(restored),
                           torch_mesh.unshard(wq))
        after = serve(pipeline)
        for name in ("logits", "nll"):
            assert torch.equal(after[name], before[name])
    finally:
        for process in processes:
            process.terminate()
        torch_mesh.set_default_devices(None)
