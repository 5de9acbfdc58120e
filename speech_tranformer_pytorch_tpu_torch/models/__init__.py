from .transformer import SpeechTransformer

__all__ = ["SpeechTransformer"]
