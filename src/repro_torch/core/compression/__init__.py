"""Read side of the compression stack: the int4 nibble codec."""
