from .asr import (                                            # noqa: F401
    AsrConfig, init_asr_params, encode_audio, decode_tokens, asr_forward,
    transcribe, transcribe_audio, transcribe_rescore, count_params)
from .configs import (                                        # noqa: F401
    WHISPER_TINY, WHISPER_SMALL, asr_flops_per_example)
from .weights import (                                        # noqa: F401
    read_safetensors, write_safetensors, SafetensorsFile, save_pytree,
    load_pytree)
from .bridge import params_from_numpy, params_to_numpy         # noqa: F401
