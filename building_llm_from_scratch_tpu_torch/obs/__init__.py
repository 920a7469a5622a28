"""Observability (port of the serving and training halves of the JAX
package's ``obs/``): the event registry (``schema.py``), the JSONL metrics
sink with fixed-bucket histograms, the rolling SLO window and the
Prometheus text (``metrics.py``), the flight recorder (``stall.py``), the
memory ledger (``memory.py``), the trainer's step timeline
(``timeline.py``), MFU against the card's peak (``mfu.py``), the
per-layer-group health bundle (``health.py``) and the metrics-JSONL to
Chrome-trace export (``trace.py``)."""
