"""Frozen operation and byte counts, and the table of the card's peaks."""
