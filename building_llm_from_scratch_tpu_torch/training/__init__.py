"""Parameter loading and export, the optimizer, the train step and the trainer."""
