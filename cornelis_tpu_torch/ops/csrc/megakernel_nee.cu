// The megakernel's "nee" instantiations (nee/uniform and nee/sobol), built
// into their own library without FMA contraction (-fmad=false, ops/build.py),
// so that every hit point, shadow ray and light sample rounds as the plain
// torch version does. See megakernel.cu for the kernel and the reason.

#define CORNELIS_MEGAKERNEL_NEE 1
#include "megakernel.cu"
