"""Training of the port: the reference's functional optimizers, int8
gradient compression with error feedback, and the fault-tolerant loop."""
