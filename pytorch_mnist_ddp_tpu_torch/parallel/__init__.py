"""Sample sharding, the train/eval steps and the sequence ring (a world
of one so far)."""
