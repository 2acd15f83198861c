"""The benchmark's yardstick, frozen: the seeded inputs (``data``), the
plain RSNN reference (``model``), the comparison that decides ``correct``
(``compare``) and the kernel peaks, bytes and operations (``counts``).
Plain PyTorch and NumPy; it imports nothing of the program."""
