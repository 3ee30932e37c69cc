"""The harness: finding a cell, driving its traffic, tracing it."""
