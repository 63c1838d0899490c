"""Runtime: device-resident columns, counters, errors."""
