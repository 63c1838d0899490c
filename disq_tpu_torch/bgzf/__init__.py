"""BGZF container: blocks, guessing, inflate/deflate."""
