"""Runtime pieces of the port: gradient compression, straggler detection."""
