"""The benchmark's general machinery: discovery by name, seeded weights,
the timed window, the trace's reduction and the check against the
reference. Nothing here is particular to one configuration, traffic mix,
entry or metric: those are files of their own, found by name."""
