"""Entries: the port's step that a cell times, and the reference call that
judges what it produced. Each module here is one entry, found by its file
name from a workload file's "entry"."""
