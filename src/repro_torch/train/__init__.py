"""Training of the port: AdamW, the train step and checkpoints
(counterparts of ``repro/train/*``)."""
