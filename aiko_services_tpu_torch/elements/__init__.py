from .ml import (                                             # noqa: F401
    LMForward, LMGenerate, SpeechToText, TextToSpeech, Detector,
    DetectionsPublish, TokensToText, TextToTokens)
from .common_io import (                                      # noqa: F401
    DataSource, DataTarget, Sample, expand_data_sources)
from .text_io import (                                        # noqa: F401
    TextReadFile, TextSource, TextTransform, TextSample, TextWriteFile,
    TextOutput)
from .compute import (                                        # noqa: F401
    ArraySource, TokenSource, MultiModalSource, JaxScale, JaxMLP, ToHost)
from .audio_io import (                                       # noqa: F401
    SAMPLE_RATE, synthesize_tone, synthesize_tone_on_device)
from .image_io import (                                       # noqa: F401
    ImageReadFile, ImageOverlay, ImageWriteFile, synthesize_image,
    synthesize_image_on_device)
from .video_io import (                                       # noqa: F401
    VideoReadFile, VideoSample, VideoWriteFile, VideoOutput)
from .robot import (                                          # noqa: F401
    RobotActor, RobotControl, RobotCameraSource, parse_actions)
