"""BAM: header, records, read source and write sink."""
