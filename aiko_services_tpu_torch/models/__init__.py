from .asr import (                                            # noqa: F401
    AsrConfig, init_asr_params, encode_audio, decode_tokens, asr_forward,
    make_asr_train_step, transcribe, transcribe_audio, transcribe_rescore,
    count_params)
from .transformer import (                                    # noqa: F401
    TransformerConfig, init_params, forward, make_train_step,
    REMAT_POLICIES, resolve_remat_policy)
from .configs import (                                        # noqa: F401
    LLAMA3_8B, LLAMA32_1B, LM_TOY, WHISPER_TINY, WHISPER_SMALL,
    transformer_flops_per_token, asr_flops_per_example)
from .optim import adam, adamw                                # noqa: F401
from .weights import (                                        # noqa: F401
    read_safetensors, write_safetensors, SafetensorsFile, save_pytree,
    load_pytree)
from .bridge import params_from_numpy, params_to_numpy         # noqa: F401
