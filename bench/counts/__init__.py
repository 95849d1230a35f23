"""Operations and bytes of the work each roofline reads, one module a
kernel: the benchmark's yardstick, not the program's."""
