from .beam import BeamResult, beam_decode, beam_search, best_hypotheses

__all__ = ["BeamResult", "beam_decode", "beam_search", "best_hypotheses"]
