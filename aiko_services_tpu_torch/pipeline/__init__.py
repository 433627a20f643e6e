from .stream import (                                          # noqa: F401
    Stream, Frame, StreamEvent, StreamState, DEFAULT_STREAM_ID,
    FIRST_FRAME_ID)
from .definition import (                                      # noqa: F401
    PipelineDefinition, ElementDefinition, DefinitionError,
    parse_pipeline_definition, validate_pipeline_definition)
from .element import (                                         # noqa: F401
    ErrorPolicy, PipelineElement, AsyncHostElement, FrameGeneratorHandle)
from .pipeline import Pipeline, RemoteElement, create_pipeline  # noqa: F401
from .tensors import (                                         # noqa: F401
    encode_frame_data, decode_frame_data, encode_value, decode_value)
from .transfer import (                                        # noqa: F401
    TensorTransferServer, fetch as fetch_tensor, get_transfer_server,
    reset_transfer_server)
from .compute_element import (                                   # noqa: F401
    ComputeElement, bucket_length, pad_axis_to)
