from .ml import SpeechToText, TokensToText                    # noqa: F401
