"""Dry-run analysis: what one rank's program computes, moves and holds
(``op_stats``), the roofline of a cell on a device (``roofline``), and
the report of a dry run's rows (``report``)."""
