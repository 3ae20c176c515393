"""World formation and the launcher, sample sharding, the train/eval steps
(one device or N data-parallel ranks) and the sequence ring (degree 1)."""
