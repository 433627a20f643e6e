from .common_io import (                                      # noqa: F401
    DataSource, DataTarget, Sample, expand_data_sources)
from .text_io import (                                        # noqa: F401
    TextReadFile, TextSource, TextTransform, TextSample, TextWriteFile,
    TextOutput)
from .toys import (                                           # noqa: F401
    PE_Number, PE_Add, PE_Busy, PE_Multiply, PE_Sum2, PE_Inspect,
    PE_Metrics, PE_RandomIntegers, PE_RandomTensor, PE_Sum)
from .compute import (                                        # noqa: F401
    ArraySource, TokenSource, MultiModalSource, JaxScale, JaxMLP, ToHost)
from .ml import (                                             # noqa: F401
    LMForward, LMGenerate, SpeechToText, TextToSpeech, Detector,
    DetectionsPublish, TokensToText, TextToTokens)
from .vision import FaceDetect, ArucoDetect                   # noqa: F401
from .robot import (                                          # noqa: F401
    RobotActor, RobotControl, RobotCameraSource, parse_actions)
from .image_io import (                                       # noqa: F401
    ImageReadFile, ImageSource, ImageResize, ImageOverlay, ImageWriteFile,
    ImageOutput, synthesize_image, synthesize_image_on_device)
from .audio_io import (                                       # noqa: F401
    AudioReadFile, AudioWriteFile, ToneSource, AudioFraming, AudioSample,
    AudioFFT, AudioResample, MicrophoneSource, SpeakerSink, SAMPLE_RATE,
    synthesize_tone, synthesize_tone_on_device)
from .video_io import (                                       # noqa: F401
    VideoReadFile, VideoSample, VideoWriteFile, VideoOutput)
from .webcam_io import VideoReadWebcam                        # noqa: F401
from .gstreamer_io import (                                   # noqa: F401
    VideoStreamReader, VideoStreamWriter, gst_available)
