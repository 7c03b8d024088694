"""Operations and bytes of one force evaluation, one module per family
(a configuration's ``counts``), on real edges."""
