"""Scheduler-side data types of the port: queries, results and node
capacity functions (copies of the reference's)."""
