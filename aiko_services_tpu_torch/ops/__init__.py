from .audio import (                                          # noqa: F401
    mel_filterbank, log_mel_spectrogram, SAMPLE_RATE, N_FFT, HOP_LENGTH,
    N_MELS)
from .device import as_device_array, resolve_device           # noqa: F401
from .kernels import launch_counts, reset_launch_counts       # noqa: F401
