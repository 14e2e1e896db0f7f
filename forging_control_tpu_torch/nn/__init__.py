"""Learning: the LSTM plant surrogate, its scalers, datasets, rollouts
and training loop."""
