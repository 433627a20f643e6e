from .asr import (                                            # noqa: F401
    AsrConfig, init_asr_params, encode_audio, decode_tokens, asr_forward,
    make_asr_train_step, transcribe, transcribe_audio, transcribe_rescore,
    count_params, asr_param_specs)
from .transformer import (                                    # noqa: F401
    TransformerConfig, init_params, forward, init_cache, init_sp_cache,
    cache_specs, param_specs, quantized_param_specs, decode_step, generate,
    generate_stream, make_train_step, quantize_weights_int8,
    REMAT_POLICIES, resolve_remat_policy, init_paged_pool, paged_prefill,
    paged_decode_step, paged_verify_step, paged_prefill_chunk, f32_head)
from .tokenizer import BPETokenizer, train_bpe                # noqa: F401
from .detector import (                                       # noqa: F401
    DetectorConfig, init_detector_params, detect, detector_forward,
    decode_boxes, non_max_suppression, make_detector_train_step)
from .yolo import (                                           # noqa: F401
    YoloV8Config, YOLOV8N, YOLO_VARIANTS, init_yolo_params,
    infer_yolov8_config, load_yolov8_params, yolo_forward, yolo_detect)
from .tts import (                                            # noqa: F401
    TTSConfig, init_tts_params, synthesize, synthesize_mel, encode_chars,
    make_tts_train_step)
from .configs import (                                        # noqa: F401
    LLAMA3_8B, LLAMA32_1B, LM_TOY, WHISPER_TINY, WHISPER_SMALL,
    YOLOV8N_SHAPE, DETECTOR_TOY, transformer_flops_per_token,
    asr_flops_per_example, detector_flops_per_image)
from .optim import adam, adamw                                # noqa: F401
from .weights import (                                        # noqa: F401
    read_safetensors, write_safetensors, SafetensorsFile, save_pytree,
    load_pytree, load_llama_params, llama_name_map, load_whisper_params,
    whisper_layer_map)
from .bridge import params_from_numpy, params_to_numpy         # noqa: F401
