"""The frozen yardstick: operation and byte counts, and the card's peaks."""
