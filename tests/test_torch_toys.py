# The port's toy elements (elements/toys.py) against the JAX package's
# twins: each definition runs through both packages' create_pipeline on
# the loopback broker, only the element module differing, and every
# output must be equal -- the toys compute in Python ints and numpy
# floats, so equal means exact.  PE_Busy keeps a tensor where it lies
# (the micro-batching contract), and PE_Sum reads a tensor back before
# numpy's sum, so a tensor and its numpy copy give the JAX element's
# float.

import queue

import numpy as np
import pytest
import torch

from aiko_services_tpu.elements import toys as jax_toys
from aiko_services_tpu.pipeline import create_pipeline as jax_create
from aiko_services_tpu.runtime import Process as JaxProcess
from aiko_services_tpu.transport import reset_brokers as jax_reset
from aiko_services_tpu_torch.elements import toys
from aiko_services_tpu_torch.pipeline import StreamEvent, create_pipeline
from aiko_services_tpu_torch.runtime import Process
from aiko_services_tpu_torch.transport import reset_brokers

PACKAGES = {
    "jax": ("aiko_services_tpu.elements", JaxProcess, jax_create,
            jax_reset),
    "torch": ("aiko_services_tpu_torch.elements", Process, create_pipeline,
              reset_brokers),
}


@pytest.fixture(autouse=True)
def clean_brokers():
    jax_reset()
    reset_brokers()
    yield
    jax_reset()
    reset_brokers()


def _definition(name, graph, elements, module):
    return {"name": name, "graph": [graph], "elements": [
        dict(element, deploy={"local": {"module": module,
                                        "class_name": element["class"]}},
             **{"class": None}) for element in elements]}


def _run(package, name, graph, elements, count):
    """[(stream variables, outputs)] of `count` frames of one stream."""
    module, process_class, create, reset = PACKAGES[package]
    reset()
    definition = _definition(name, graph, elements, module)
    for element in definition["elements"]:
        del element["class"]
    process = process_class(transport_kind="loopback")
    try:
        pipeline = create(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        pipeline.create_stream("s1", queue_response=responses)
        results = [responses.get(timeout=30) for _ in range(count)]
    finally:
        process.terminate()
    return [(stream.variables, outputs) for stream, _, outputs in results]


def _both(name, graph, elements, count=1):
    return (_run("jax", name, graph, elements, count),
            _run("torch", name, graph, elements, count))


def test_diamond_through_pe_sum2():
    """tests/test_pipeline.py's diamond: a number fans out to two PE_Add
    and meets again in PE_Sum2 through map_in."""
    elements = [
        {"name": "source", "output": [{"name": "number"}],
         "parameters": {"data_sources": [10]}, "class": "PE_Number"},
        {"name": "add_a", "input": [{"name": "number"}],
         "output": [{"name": "number"}], "map_out": {"number": "number_a"},
         "parameters": {"constant": 1}, "class": "PE_Add"},
        {"name": "add_b", "input": [{"name": "number"}],
         "output": [{"name": "number"}], "map_out": {"number": "number_b"},
         "parameters": {"constant": 100}, "class": "PE_Add"},
        {"name": "join", "input": [{"name": "a"}, {"name": "b"}],
         "output": [{"name": "number"}],
         "map_in": {"a": "number_a", "b": "number_b"}, "class": "PE_Sum2"},
    ]
    (jax_run,), (port_run,) = _both(
        "diamond", "(source (add_a join) (add_b join))", elements)
    assert port_run[1] == jax_run[1]
    assert port_run[1]["number"] == (10 + 1) + (10 + 100)


def test_random_integers_multiply_busy_chain():
    """Seeded integers through PE_Multiply and PE_Busy, frame by frame."""
    elements = [
        {"name": "source", "output": [{"name": "number"}],
         "parameters": {"data_sources": [3, 7, 11, 42]},
         "class": "PE_RandomIntegers"},
        {"name": "double", "input": [{"name": "number"}],
         "output": [{"name": "number"}], "parameters": {"constant": 2},
         "class": "PE_Multiply"},
        {"name": "busy", "input": [{"name": "number"}],
         "output": [{"name": "number"}],
         "parameters": {"work_ms": 1, "constant": 5}, "class": "PE_Busy"},
    ]
    jax_run, port_run = _both("chain", "(source (double (busy)))",
                              elements, count=4)
    got = sorted(outputs["number"] for _, outputs in port_run)
    want = sorted(outputs["number"] for _, outputs in jax_run)
    assert got == want
    assert all(isinstance(value, int) for value in got)


def test_random_tensor_sum():
    """PE_RandomTensor's seeded values reduced by PE_Sum: the same f32
    array, the same numpy sum."""
    elements = [
        {"name": "source", "output": [{"name": "values"}],
         "parameters": {"data_sources": [4096, 17]},
         "class": "PE_RandomTensor"},
        {"name": "total", "input": [{"name": "values"}],
         "output": [{"name": "number"}], "class": "PE_Sum"},
    ]
    jax_run, port_run = _both("sum", "(source (total))", elements, count=2)
    assert (sorted(outputs["number"] for _, outputs in port_run)
            == sorted(outputs["number"] for _, outputs in jax_run))


def test_inspect_and_metrics_record_the_stream():
    """PE_Inspect passes its inputs on and records them in the stream's
    "inspected" variable; PE_Metrics records the frame's metric names."""
    elements = [
        {"name": "source", "output": [{"name": "number"}],
         "parameters": {"data_sources": [5]}, "class": "PE_Number"},
        {"name": "probe", "input": [{"name": "number"}],
         "output": [{"name": "number"}], "parameters": {"log": True},
         "class": "PE_Inspect"},
        {"name": "metrics", "input": [{"name": "number"}], "output": [],
         "class": "PE_Metrics"},
    ]
    (jax_run,), (port_run,) = _both(
        "inspect", "(source (probe (metrics)))", elements)
    assert port_run[1] == jax_run[1]
    assert (port_run[0]["inspected"] == jax_run[0]["inspected"]
            == [{"number": 5}])
    assert (len(port_run[0]["metrics_history"])
            == len(jax_run[0]["metrics_history"]) == 1)
    assert (sorted(port_run[0]["metrics_history"][0])
            == sorted(jax_run[0]["metrics_history"][0]))


def _element(cls, params=None):
    params = params or {}
    element = cls.__new__(cls)
    element.get_parameter = (lambda name, default=None, stream=None:
                             params.get(name, default))
    return element


def test_busy_keeps_a_tensor_where_it_lies():
    """A tensor input is multiplied where it lies (it stays a tensor on
    its device, shape kept), equal to the JAX element on its numpy
    copy."""
    values = np.random.default_rng(0).standard_normal((4, 3)).astype(
        np.float32)
    params = {"work_ms": 0, "constant": 3}
    event, outputs = toys.PE_Busy.process_frame(
        _element(toys.PE_Busy, params), None, torch.from_numpy(values))
    _, expected = jax_toys.PE_Busy.process_frame(
        _element(jax_toys.PE_Busy, params), None, values)
    assert event == StreamEvent.OKAY
    assert isinstance(outputs["number"], torch.Tensor)
    assert outputs["number"].device.type == "cpu"
    np.testing.assert_array_equal(outputs["number"].numpy(),
                                  np.asarray(expected["number"]))


def test_sum_of_a_tensor_equals_numpy_sum():
    values = np.random.default_rng(1).standard_normal(1000).astype(
        np.float32)
    _, outputs = toys.PE_Sum.process_frame(
        _element(toys.PE_Sum), None, torch.from_numpy(values))
    _, expected = jax_toys.PE_Sum.process_frame(
        _element(jax_toys.PE_Sum), None, values)
    assert outputs["number"] == expected["number"]
