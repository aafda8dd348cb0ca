"""Host-side utilities of the port: the ensemble mirror that serves RL
rollouts, tree introspection, the C-header export and its native runtime,
the reference binary format in both directions, and profiling."""
