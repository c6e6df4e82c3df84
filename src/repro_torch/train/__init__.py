"""Training: AdamW, the train step and the host loop (the port of ``repro/train``)."""
