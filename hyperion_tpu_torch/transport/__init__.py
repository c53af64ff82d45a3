"""The port's transport layer: tables, samplers, the Lucy step with its
deposit_visit kernel, and the Lucy iterations."""
