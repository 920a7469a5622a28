"""The transformer model for serving."""
