from .beam import BeamResult, beam_decode, beam_search, best_hypotheses
from .greedy import GreedyResult, greedy_decode, greedy_search, tokens_to_lists

__all__ = ["BeamResult", "GreedyResult", "beam_decode", "beam_search",
           "best_hypotheses", "greedy_decode", "greedy_search", "tokens_to_lists"]
