"""The continuous-batching serving engine and its frontend."""
