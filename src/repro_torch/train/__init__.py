"""Training on one device (port of ``repro.train``): optimizers, the train
step and the monitored loop."""
