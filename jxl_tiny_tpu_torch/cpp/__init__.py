"""The native host packer (pack.cc), built with g++ at first use."""
