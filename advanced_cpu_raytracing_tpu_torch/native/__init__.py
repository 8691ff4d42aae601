"""Host-side native code: the BVH builder (``bvh_builder.cpp``, bound in
``accel/bvh.py``) and the binary PLY reader (``ply_reader.cpp``, bound in
``bindings.py``), each compiled with g++ at first use by ``build.py``."""
