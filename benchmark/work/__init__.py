"""Operations and bytes of the program's work, computed from shapes, and
the H100's peaks they are held to."""
