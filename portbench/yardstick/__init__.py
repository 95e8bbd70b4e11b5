"""The benchmark's frozen yardstick: the card's peaks and the operation
and byte counts that the roofline and MFU metrics divide by."""
