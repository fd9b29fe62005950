"""Host-side runtime helpers: device choice and the monitor-grid NN map."""
