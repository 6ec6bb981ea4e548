"""Training (port of ``repro.train``): optimizers, the train step and the
monitored loop, on one device or data-parallel over a mesh, and the
gradient compression of the cross-pod exchange."""
