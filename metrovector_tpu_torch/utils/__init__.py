"""Host ↔ device transfer and timing on the card."""
