"""Plain-text SAM support (reference parity: ``impl/formats/sam/``)."""
