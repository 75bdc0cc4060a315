"""Real-time host runtime of the PyTorch port: bridge, sensor feed,
estimator thread and the dual-cadence control loop."""
