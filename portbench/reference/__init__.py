"""Plain PyTorch reference of the Speech-Transformer, in float32 with TF32
off: the Kaldi-style fbank + CMVN front end, SpecAugment, the pre-LN
encoder-decoder with u8-bit dropout, the label-smoothed loss and clipped
Adam under the Noam schedule.

It imports neither the JAX package nor the port, and takes nothing the
port made: it works the features, the masks and the dropout bits out
again from the benchmark's inputs and seeds. The module names follow the
port's ``state_dict`` keys, because that dictionary is what both sides are
handed.
"""
