"""Data and tensor parallelism over a ('data', 'model') mesh of ranks
(counterpart of the JAX package's ``parallel/``): ``mesh`` (ranks and
groups), ``tp`` (Megatron collectives), ``sharding`` (the rules and the
sharded steps), ``ring_attention``, ``beam_exchange`` and ``decode``."""
