"""Work across devices: the collectives, the sharding rules, ring attention
over ``sequence``, the MoE layer over ``expert`` and the pipeline over
``pipe``."""
