"""World formation and the launcher, sample sharding, the train/eval steps
(one device or N data-parallel ranks), and the ViT's parallel modes over a
(data, seq, model) rank grid: the sequence ring and Ulysses, tensor
parallelism and their 3-D composition."""
