// Native host-side runtime for nemotron_tpu_torch (a copy of the JAX
// package's native/nemotron_host.cpp).
//
// The accelerator does all model math; what remains on the host at high stream counts
// is byte-moving and O(samples) DSP bookkeeping. These are the hot host paths,
// implemented in C++ and bound via ctypes (the reference keeps the analogous
// code in C++ too: src/preprocessor.cpp buffering, src/nemo-server.cpp framing).
//
// Exposed C ABI:
//   pcm_i16_to_f32_preemph : s16le -> f32 scale 1/32768 + pre-emphasis carry
//   preemph_f32            : pre-emphasis on already-float audio
//   frame_signal           : strided copy into [n_frames, frame_len] windows
//
// Build: g++ -O3 -shared -fPIC -o libnemotron_host.so nemotron_host.cpp

#include <cstdint>
#include <cstring>

extern "C" {

// Convert s16le PCM to f32 in [-1, 1] and apply pre-emphasis with a carried
// previous sample. Returns the new carry (the last raw sample, scaled).
// Matches src/preprocessor.cpp:344-356 semantics.
float pcm_i16_to_f32_preemph(
    const int16_t* in, int64_t n, float preemph, float last_sample,
    float* out)
{
    const float scale = 1.0f / 32768.0f;
    float prev = last_sample;
    for (int64_t i = 0; i < n; i++) {
        const float cur = in[i] * scale;
        out[i] = cur - preemph * prev;
        prev = cur;
    }
    return prev;
}

// Pre-emphasis on float input (same carry contract).
float preemph_f32(
    const float* in, int64_t n, float preemph, float last_sample, float* out)
{
    float prev = last_sample;
    for (int64_t i = 0; i < n; i++) {
        const float cur = in[i];
        out[i] = cur - preemph * prev;
        prev = cur;
    }
    return prev;
}

// Extract overlapping frames: out[t, :] = in[t*hop : t*hop + frame_len].
// Caller guarantees n_in >= (n_frames-1)*hop + frame_len.
void frame_signal(
    const float* in, int64_t n_frames, int64_t hop, int64_t frame_len,
    float* out)
{
    for (int64_t t = 0; t < n_frames; t++) {
        std::memcpy(out + t * frame_len, in + t * hop,
                    (size_t)frame_len * sizeof(float));
    }
}

}  // extern "C"
