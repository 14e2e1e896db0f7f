"""Learning: the FNN controller and the LSTM plant surrogate, their
scalers, datasets, rollouts and training loops."""
