# Architecture configs: one module per assigned arch + registry + shapes.
