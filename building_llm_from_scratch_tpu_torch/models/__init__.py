"""The transformer model: training forward and serving forward passes."""
