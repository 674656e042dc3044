"""The least work of the operations the roofline metrics read: bytes and
FLOPs from shapes, each input byte read once and each output byte written
once, whatever implements the work.  Frozen here so that a change to the
program cannot move the yardstick."""
