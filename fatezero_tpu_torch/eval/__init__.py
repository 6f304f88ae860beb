"""Benchmark evaluation of edited videos: CLIP Frame-Accuracy and Temporal-Consistency."""
