"""Learning-rate schedules and the optimizer."""
