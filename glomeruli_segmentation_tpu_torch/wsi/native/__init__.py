"""The native slide reader's C++ source (``ndpi_reader.cc``), the libjpeg
and zlib headers it compiles against (``include/``, with their licences),
and :mod:`._build`, which compiles it at first use."""
