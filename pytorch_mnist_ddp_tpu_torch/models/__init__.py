"""The reference CNN, its int8 serving variant, and the ViT."""
