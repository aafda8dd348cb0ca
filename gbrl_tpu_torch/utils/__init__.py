"""Host-side utilities of the port (the ensemble mirror that serves RL
rollouts)."""
