"""Host-side graph generators and seed selection."""
