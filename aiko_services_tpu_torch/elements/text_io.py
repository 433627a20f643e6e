# Text I/O elements: the pipeline correctness suite.
#
# Counterpart of aiko_services_tpu/elements/text_io.py (capability parity
# with the reference text elements, reference:
# src/aiko_services/elements/media/text_io.py:64-179): TextReadFile,
# TextSource (in-memory prompts, the source of
# examples/pipeline_llm_8b.json), TextTransform (case operations),
# TextSample (drop-frame by rate -- the reference's documented
# local/remote drop-frame test vehicle, text_io.py:21-26), TextWriteFile,
# TextOutput.  Host elements: nothing here touches a device.

from __future__ import annotations

from pathlib import Path

from ..pipeline import StreamEvent, PipelineElement
from .common_io import DataSource, DataTarget, Sample

__all__ = ["TextReadFile", "TextTransform", "TextSample", "TextWriteFile",
           "TextOutput", "TextSource"]


class TextReadFile(DataSource):
    def read_item(self, stream, item) -> dict:
        return {"text": Path(item).read_text()}


class TextSource(DataSource):
    """In-memory text source: data_sources is a list of LITERAL strings
    (no path/glob expansion -- prompts legitimately contain ? and *)."""

    expand_sources = False

    def read_item(self, stream, item) -> dict:
        return {"text": str(item)}


class TextTransform(PipelineElement):
    def process_frame(self, stream, text):
        transform = self.get_parameter("transform", "none", stream)
        if transform == "lower":
            text = text.lower()
        elif transform == "upper":
            text = text.upper()
        elif transform == "title":
            text = text.title()
        elif transform != "none":
            return StreamEvent.ERROR, {
                "diagnostic": f"unknown transform: {transform}"}
        return StreamEvent.OKAY, {"text": text}


class TextSample(Sample):
    """Pass every Nth frame, drop the rest (reference text_io.py:108-115)."""


class TextWriteFile(DataTarget):
    def process_frame(self, stream, text):
        path = self.next_target_path(stream)
        Path(path).write_text(text)
        return StreamEvent.OKAY, {"path": path}


class TextOutput(PipelineElement):
    """Collect text into stream variables (assertion point for tests,
    like the reference PE_Inspect idiom)."""

    def process_frame(self, stream, text):
        collected = stream.variables.setdefault("text_output", [])
        collected.append(text)
        return StreamEvent.OKAY, {"text": text}
