"""Analytic counts: the operations and bytes a call needs, from its shapes,
and the card's published peaks. Frozen here so that a change to the program
cannot change the yardstick."""
