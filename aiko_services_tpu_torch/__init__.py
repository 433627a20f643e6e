# aiko_services_tpu_torch: the PyTorch and CUDA port of aiko_services_tpu.
#
# The JAX package (aiko_services_tpu/) is the reference and stays as it
# is; this package mirrors its layout module for module and imports
# nothing from it.  Plain tensor code is PyTorch run eagerly on an
# explicit device (CUDA unless the caller asks for the CPU); every Pallas
# TPU kernel on a ported path is a kernel written by hand for Hopper
# (csrc/, built with nvcc at first use, loaded through ctypes).
#
# Layering, as in the JAX package:
#   utils/ transport/ runtime/ observe/ analyze/ faults.py
#              copies of the JAX package's jax-free layers
#   pipeline/  the pipeline engine; compute_element.py is the
#              counterpart of tpu_element.py
#   ops/       device helpers, log-mel frontend, kernel build/load
#   parallel/  attention: the flash-attention kernel and its plain version
#   models/    Whisper-style ASR, the LM (with its paged KV steps), the
#              detector, layers, configs, safetensors, bridge
#   decode/    the continuous decode engine (paged KV blocks, the
#              slot scheduler, the prefix cache, the prefill engine, the
#              decode-state checkpointer and its keeper)
#   serve/     the serving gateway (admission, routing, failover, the
#              journal, disaggregation, federation)
#   elements/  SpeechToText, LMGenerate, Detector, the text and source
#              elements
#   csrc/      CUDA C++ kernel sources

__version__ = "0.1.0"
