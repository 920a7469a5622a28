"""Serving observability (port of the serving half of the JAX package's
``obs/``): the event registry (``schema.py``), the JSONL metrics sink with
fixed-bucket histograms, the rolling SLO window and the Prometheus text
(``metrics.py``), the hung-tick flight recorder (``stall.py``) and the
serving memory ledger (``memory.py``). The training telemetry (mfu, the
health bundle, the step timeline, ``--log_every``) is not ported."""
