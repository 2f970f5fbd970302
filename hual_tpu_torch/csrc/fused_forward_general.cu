// K2's general kernel: fused_forward.cu built with every route (the tiled
// dense and CQ products, grouped and streamed attention, LayerNorm in
// chunks, the scalar tails), for the shapes its resident kernel does not
// take (fused_forward_takes).  The resident kernel, that file's own build,
// keeps the code the shapes of the old limit ran before the routes existed.
#define K2_GENERAL 1
#include "fused_forward.cu"
