# The port's native S-expression parser (native/sexpr_codec.cpp, built
# with g++ by native/build.py): the corpus of tests/test_native.py through
# the native parser and the port's Python parser, whose results must be
# equal (errors included), and utils.sexpr.parse on the native path once
# the extension is loaded.  The extension is built into a temporary
# directory, not the repo's build/native/, and the module state is put
# back after.  No timing is asserted: chip_smoke.py prints both parsers'
# per-message times.

import shutil

import pytest

from aiko_services_tpu_torch import native
from aiko_services_tpu_torch.native.build import build
from aiko_services_tpu_torch.utils import sexpr
from test_native import CORPUS, MALFORMED


@pytest.fixture(scope="module")
def native_parse(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    saved = native._ext, native.sexpr_parse_native
    target = build(tmp_path_factory.mktemp("native"), verbose=False)
    assert target is not None, "g++ is present but the build failed"
    assert native.sexpr_parse_native is not None
    try:
        yield native.sexpr_parse_native
    finally:
        native._ext, native.sexpr_parse_native = saved


def test_native_matches_python_on_corpus(native_parse):
    for payload in CORPUS:
        expected = sexpr._parse_python(payload)
        assert native_parse(payload) == expected, f"mismatch on {payload!r}"
        assert sexpr.parse(payload) == expected


def test_native_roundtrip_generate(native_parse):
    payload = sexpr.generate(
        "process_frame",
        [{"stream_id": "7", "frame_id": "3"}, {"x": "1", "y": "2"}])
    assert native_parse(payload) == sexpr._parse_python(payload)
    assert sexpr.parse(payload) == ("process_frame", [
        {"stream_id": "7", "frame_id": "3"}, {"x": "1", "y": "2"}])


def test_native_malformed_raises_parse_error(native_parse):
    for payload in MALFORMED:
        with pytest.raises(sexpr.ParseError):
            native_parse(payload)
        with pytest.raises(sexpr.ParseError):
            sexpr.parse(payload)
        with pytest.raises(sexpr.ParseError):
            sexpr._parse_python(payload)


def test_native_binary_canonical_symbols(native_parse):
    blob = bytes(range(256)).decode("latin-1")
    payload = f"(blob {len(blob)}:{blob})"
    command, parameters = native_parse(payload)
    assert command == "blob"
    assert parameters[0] == blob
    assert sexpr._parse_python(payload) == (command, parameters)


def test_parse_falls_back_to_python_for_non_latin1(native_parse):
    payload = "(say ☃ snow)"
    assert sexpr.parse(payload) == sexpr._parse_python(payload) == (
        "say", ["☃", "snow"])


def test_extension_names_its_source_digest(tmp_path):
    """A build directory without this source's extension loads nothing,
    and the path carries the source's digest (an edited source is never
    served by a stale library)."""
    path = native.extension_path(tmp_path)
    assert path.parent == tmp_path
    assert path.name.startswith("_sexpr_native-")
    assert native.load(tmp_path) is False
