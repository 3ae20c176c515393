"""Sample sharding and the train/eval steps (a world of one so far)."""
