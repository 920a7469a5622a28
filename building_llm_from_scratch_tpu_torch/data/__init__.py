"""Tokenizers and the pretraining data pipeline."""
