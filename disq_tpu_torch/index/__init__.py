"""BAI and SBI indexes."""
