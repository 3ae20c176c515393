"""The reference CNN and its int8 serving variant."""
