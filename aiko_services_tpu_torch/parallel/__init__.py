from .attention import (                                      # noqa: F401
    attention_reference, flash_attention, flash_attention_forward,
    flash_attention_plain)
