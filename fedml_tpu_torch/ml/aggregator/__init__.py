"""Server-side aggregation."""
